"""Stochastic decoding: temperature / top-k / top-p (nucleus) sampling.

Port of ``qwen3_asr_rs_tpu/runtime/sampling.py``. ``SamplingParams``,
``normalize``, the filters and ``filtered_probs`` compute what the JAX
functions compute; ``top_k`` and ``top_p`` are Python values (a
disabled filter adds no work: a nucleus filter is a full-vocabulary
sort per step), ``temperature`` a scalar or a per-row (B,) tensor, and
rows at temperature <= 0 take the argmax inside the same step.

Random draws. torch cannot reproduce JAX's random stream, so the draws
are counter-based instead: each (seed, counter, row, column) is hashed
with integer tensor ops (``draw_bits``) into 32 random bits (seed and
counter may be per row, as a serving scheduler's slots need), and a token
is drawn by Gumbel-max over the filtered logits, as
``jax.random.categorical`` draws. The engine's counter is the token's
index in the transcript (the prefill's token 0, decode step i's token
i + 1), the counter of JAX's ``fold_in(base_key, step + 1)``. The hash
needs no generator state, so a step captured in a CUDA graph draws
afresh at every replay from the device counter that the graph advances;
and it runs on int64 values below 2^63 only (no signed wrap-around), so
the CPU and the card give the same bits.

Speculative sampling (the engine's ``_spec_generate``) maps JAX's keys
(``fold_in(base_key, it + 1)`` per iteration, ``fold_in(key_it, 2 + i)``
per draft step, ``fold_in(key_it, 0)`` for the accept) onto the same
hash: the prefill's token is counter 0; iteration ``it`` is counter
``it + 1``, its draft step i draws on stream ``2 + i``, and
``speculative_accept`` at that counter keeps streams 0 (the acceptance
uniforms) and 1 (the replacement or bonus token). Iterations, not
tokens, key the draws: an iteration emits a data-dependent number of
tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


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


# ---- counter-based random bits ---------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x, c: int):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): the constant split in
    16-bit halves keeps every product below 2^48."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """A 32-bit finalizer (lowbias32: xorshift-multiply, 2 rounds) on
    int64 values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _as_i64(v, device):
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return torch.tensor(int(v), dtype=torch.int64, device=device)


def draw_bits(seed, counter, rows: int, cols: int, device="cpu",
              stream: int = 0, row0: int = 0):
    """(rows, cols) int64 random 32-bit values, a pure function of
    (seed, counter, stream, row, column). ``seed`` and ``counter`` are
    ints or 0-d integer tensors (a device counter stays on the device);
    ``stream`` separates independent draws at one counter (JAX's
    ``fold_in(key, stream)``).

    Per-row keys: either may also be a (rows,) tensor, one seed and
    counter per row (the serving scheduler's slots). Row r's bits are
    then a function of (seed[r], counter[r], stream, column) alone, the
    bits a scalar call with that seed and counter gives its row 0: where
    a row sits in the batch does not enter them.

    ``row0``: the index of the first row (scalar keys): a data-parallel
    rank's rows draw as rows [row0, row0 + rows) of the whole batch."""
    seed = _as_i64(seed, device)
    counter = _as_i64(counter, device)
    k = _mix32((seed & _M32) ^ _mix32((seed >> 32) & _M32))
    k = _mix32(k ^ _mix32(counter & _M32))
    k = _mix32(k ^ stream)
    row = torch.arange(row0, row0 + rows, dtype=torch.int64, device=device)
    if k.ndim:  # per-row keys: every row draws as row 0
        row = torch.zeros_like(row)
    k = _mix32(k ^ _mix32(row))[:, None]  # (rows, 1)
    col = torch.arange(cols, dtype=torch.int64, device=device)
    return _mix32(k ^ col[None, :])


def uniforms(seed, counter, rows: int, cols: int, device="cpu",
             stream: int = 0, row0: int = 0):
    """(rows, cols) float32 uniforms in (0, 1) from ``draw_bits``
    (``unit_from_bits``)."""
    return unit_from_bits(draw_bits(seed, counter, rows, cols, device, stream,
                                    row0))


def unit_from_bits(bits):
    """float32 values strictly inside (0, 1) from 32-bit ints: the top 23
    bits, centred in their interval. Each value is exact in float32; 24
    bits would round the largest to 1.0, whose Gumbel noise
    -log(-log(u)) is +inf (and NaN at a filtered -inf logit), so that
    ``argmax`` would take a token the filters removed."""
    return ((bits >> 9).to(torch.float32) + 0.5) * (2.0 ** -23)


def _gumbel_argmax(logits, seed, counter, stream: int = 0, row0: int = 0):
    """argmax(logits + Gumbel noise) per row of (B, V) logits: a draw from
    softmax(logits) (-inf entries are never drawn)."""
    b, v = logits.shape
    u = uniforms(seed, counter, b, v, logits.device, stream, row0)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


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


def sample_token(logits, seed, counter, temperature, top_k: int = 0,
                 top_p=1.0, stream: int = 0, row0: int = 0):
    """One decode-step sample: (B, V) or (V,) logits -> int64 ids.

    ``seed``/``counter`` key the draw (``draw_bits``; the engine's counter
    is the token index, a speculative draft step's its iteration and
    ``stream`` 2 + i): scalars, or (B,) tensors of per-row keys.
    ``temperature`` may be a scalar or a per-row (B,) tensor; rows with
    temperature <= 0 take the argmax. As in JAX,
    the top-k filter keeps every logit tied with the k-th, so ``top_k =
    1`` draws among tied largest logits where greedy takes the lowest
    index. ``row0``: the first row's index in the whole batch
    (``draw_bits``). Returns ids with the logits' leading shape.
    """
    squeeze = logits.ndim == 1
    if squeeze:
        logits = logits[None]
    greedy = torch.argmax(logits, dim=-1)
    logits, temp, scaled = _scaled(logits, temperature, top_k, top_p)
    sampled = _gumbel_argmax(scaled, seed, counter, stream, row0)
    out = torch.where(temp > 0, sampled, greedy)
    return out[0] if squeeze else out


def filtered_probs(logits, temperature, top_k: int = 0, top_p=1.0):
    """The distribution ``sample_token`` draws from, as probabilities:
    softmax(top_p(top_k(logits / T)))."""
    return torch.softmax(_scaled(logits, temperature, top_k, top_p)[2], -1)


def speculative_accept(seed, counter, drafts, q_probs, p_probs):
    """Rejection step of speculative sampling (Leviathan/Chen et al.).

    ``drafts``: (k,) proposals d_1..d_k drawn from the draft
    distributions ``q_probs`` (k, V); ``p_probs`` (k+1, V) are the
    target distributions at the same positions plus the bonus position.
    Each d_i is accepted with probability min(1, p_i(d_i) / q_i(d_i));
    at the first rejection r the replacement token is drawn from the
    residual norm(max(p_r - q_r, 0)), and when all k are accepted the
    bonus token is drawn from p_{k+1}. Returns (acc, next_token), 0-d
    int64 tensors: next_token is distributed as sequential sampling from
    the target. (seed, counter) key the draws: stream 0 the acceptance
    uniforms, stream 1 the replacement. ``acc`` selects rows by
    ``index_select``, never by a 0-d index (which reads it on the host),
    so that a CUDA graph can capture the step.
    """
    k = drafts.shape[0]
    dev = p_probs.device
    u = uniforms(seed, counter, 1, k, dev, stream=0)[0]
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
    return acc, _gumbel_argmax(logp, seed, counter, stream=1)[0]
