"""Stochastic decoding: temperature / top-k / top-p (nucleus) sampling.

Port of ``qwen3_asr_rs_tpu/runtime/sampling.py``. ``SamplingParams``,
``normalize``, the filters and ``filtered_probs`` compute what the JAX
functions compute; ``top_k`` and ``top_p`` are Python values (a
disabled filter adds no work: a nucleus filter is a full-vocabulary
sort per step), ``temperature`` a scalar or a per-row (B,) tensor, and
rows at temperature <= 0 take the argmax inside the same step.

Random draws come from JAX's own threefry stream (``ops/prng.py``), so a
seed gives the JAX package's tokens: ``sample_token(logits, key, ...)``
and ``speculative_accept(key, ...)`` take JAX's keys and draw as JAX's
functions do. A key is a (2,) key tensor or a ``prng.KeyChain`` (a base
key on the device and the ``fold_in`` data to apply), whose key the
draw kernel derives itself: a step captured in a CUDA graph draws with
the key of the step counter it advances. On CUDA every draw runs the
threefry Gumbel-max kernel (``ops/kernels/gumbel_argmax.py``); on the
CPU its plain version, ``prng.categorical``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..ops.kernels.gumbel_argmax import gumbel_argmax, threefry_noise
from ..ops.prng import KeyChain, as_chain


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Decoding hyper-parameters for one transcription call.

    ``temperature <= 0`` means pure greedy (the default — identical
    tokens to not passing params at all). ``top_k = 0`` and
    ``top_p >= 1`` disable those filters.
    """

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0

    def validate(self) -> "SamplingParams":
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {self.top_p}"
            )
        if self.temperature < 0.0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}"
            )
        return self


def normalize(params: Optional[SamplingParams]) -> SamplingParams:
    """None -> greedy params; otherwise validated as-is."""
    if params is None:
        return SamplingParams()
    return params.validate()


# ---- filters ---------------------------------------------------------


def apply_top_k(logits, top_k: int):
    """Keep the ``top_k`` largest logits per row, -inf the rest.

    0 (or >= vocab) is the identity.
    """
    if top_k <= 0 or top_k >= logits.shape[-1]:
        return logits
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, -torch.inf, logits)


def apply_top_p(logits, top_p):
    """Nucleus filter: keep the smallest prefix of the descending-prob
    distribution whose mass reaches ``top_p``; -inf the rest.

    The highest-probability token is always kept (``cum - p < top_p``
    is strict-before semantics), so the filter can never empty a row.
    ``top_p`` is a float (>= 1 is the identity and adds no work) or a
    scalar / per-row (B,) tensor (rows at 1.0 keep every token).
    """
    if isinstance(top_p, (int, float)):
        if top_p >= 1.0:
            return logits
        pcol = top_p
    else:
        p = top_p.to(device=logits.device, dtype=torch.float32)
        pcol = p[..., None] if p.ndim else p
    desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < pcol  # keep while mass BEFORE token < p
    thresh = torch.where(keep, desc, torch.inf).amin(-1, keepdim=True)
    return torch.where(logits < thresh, -torch.inf, logits)


def _scaled(logits, temperature, top_k: int, top_p):
    """(float32 logits, temperature tensor, filtered logits / T)."""
    logits = logits.to(torch.float32)
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device)
    tcol = temp[..., None] if temp.ndim else temp
    scaled = logits / torch.clamp(tcol, min=1e-6)
    scaled = apply_top_k(scaled, top_k)
    return logits, temp, apply_top_p(scaled, top_p)


def sample_token(logits, key, temperature, top_k: int = 0, top_p=1.0,
                 row_offset=0):
    """One decode-step sample: (B, V) or (V,) logits -> int64 ids, JAX's
    ``sample_token``: ``categorical(key, top_p(top_k(logits / T)))``.

    ``key``: a key tensor or a ``prng.KeyChain`` (JAX's key for the step,
    e.g. ``fold_in(base, step + 1)``). ``temperature`` may be a scalar or
    a per-row (B,) tensor; rows with temperature <= 0 take the argmax. As
    in JAX, the top-k filter keeps every logit tied with the k-th, so
    ``top_k = 1`` draws among tied largest logits where greedy takes the
    lowest index. ``row_offset``: the rows draw as rows ``row_offset +
    r`` of a wider array (or as rows ``row_offset[r]``, a (B,) int64
    tensor), the rows a rank holds of JAX's whole (B, V) draw. Returns
    ids with the logits' leading shape.
    """
    squeeze = logits.ndim == 1
    if squeeze:
        logits = logits[None]
    greedy = torch.argmax(logits, dim=-1)
    logits, temp, scaled = _scaled(logits, temperature, top_k, top_p)
    sampled = gumbel_argmax(scaled, key, row_offset)
    out = torch.where(temp > 0, sampled, greedy)
    return out[0] if squeeze else out


def filtered_probs(logits, temperature, top_k: int = 0, top_p=1.0):
    """The distribution ``sample_token`` draws from, as probabilities:
    softmax(top_p(top_k(logits / T)))."""
    return torch.softmax(_scaled(logits, temperature, top_k, top_p)[2], -1)


def speculative_accept(key, drafts, q_probs, p_probs):
    """Rejection step of speculative sampling (Leviathan/Chen et al.).

    ``drafts``: (k,) proposals d_1..d_k drawn from the draft
    distributions ``q_probs`` (k, V); ``p_probs`` (k+1, V) are the
    target distributions at the same positions plus the bonus position.
    Each d_i is accepted with probability min(1, p_i(d_i) / q_i(d_i));
    at the first rejection r the replacement token is drawn from the
    residual norm(max(p_r - q_r, 0)), and when all k are accepted the
    bonus token is drawn from p_{k+1}. Returns (acc, next_token), 0-d
    int64 tensors: next_token is distributed as sequential sampling from
    the target. ``key`` (a key tensor or ``prng.KeyChain``) keys the
    draws as JAX's: ``uniform(fold_in(key, 0), (k,))`` for the
    acceptance, ``categorical(fold_in(key, 1), ...)`` for the
    replacement. ``acc`` selects rows by ``index_select``, never by a 0-d
    index (which reads it on the host), so that a CUDA graph can capture
    the step.
    """
    k = drafts.shape[0]
    dev = p_probs.device
    chain = as_chain(key)
    u = threefry_noise(_fold(chain, 0), (1, k), "uniform", device=dev)[0]
    ar = torch.arange(k, device=dev)
    d = drafts.long()
    pi, qi = p_probs[ar, d], q_probs[ar, d]
    ok = u * torch.clamp(qi, min=1e-30) < pi  # u < min(1, p/q), sort-free
    acc = torch.cumprod(ok.long(), 0).sum()
    p_acc = p_probs.index_select(0, acc.reshape(1))[0]
    q_acc = torch.where(
        acc < k, q_probs.index_select(0, torch.clamp(acc, max=k - 1)
                                      .reshape(1))[0],
        torch.zeros_like(p_acc))
    res = torch.clamp(p_acc - q_acc, min=0.0)
    total = res.sum()
    # at a true rejection the residual has positive mass by construction;
    # if rounding kills it, fall back to the target distribution
    probs = torch.where(total > 1e-12, res / torch.clamp(total, min=1e-30),
                        p_acc)
    logp = torch.log(torch.clamp(probs, min=1e-30))[None]
    return acc, gumbel_argmax(logp, _fold(chain, 1))[0]


def _fold(chain: KeyChain, data) -> KeyChain:
    """``fold_in(chain, data)``, still as a chain."""
    return KeyChain(chain.base, chain.data + (data,))
