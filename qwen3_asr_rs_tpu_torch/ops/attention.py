"""Attention ops (port of ``qwen3_asr_rs_tpu/ops/attention.py``).

Activations are (batch, seq, heads, head_dim). GQA never repeats K/V:
query heads are grouped (B, S, Hkv, G, D) and the contractions broadcast
over the group. Masks are additive with the finite ``MASK_VALUE`` so
fully-masked (padding) rows stay NaN-free, and softmax runs in float32
whatever the compute dtype. ``attention`` dispatches to the flash kernel
(``kernels/flash_attention.py``, K3) by ``auto_attention_impl``: bf16
calls on CUDA by the crossover measured on an H100, float32 calls by the
JAX package's score-bytes rule, with "on TPU" read as "on CUDA".
"""

from __future__ import annotations

import os

import torch

from ..utils import tracing

# Large negative additive-mask value: exp(x - max) underflows to exactly
# 0 for any real max, so results match a -inf mask without NaN rows.
MASK_VALUE = -1e9


def auto_attention_impl(b: int, hq: int, sq: int, sk: int, on_cuda: bool,
                        *, dtype: torch.dtype, head_dim: int,
                        grad: bool) -> str:
    """'flash' or 'dense' for the auto dispatch.

    - Off CUDA, or with a gradient to pass (``grad``: q, k or v requires
      one; K3 has no backward), or at a head_dim K3 does not take: dense.
    - bf16 on CUDA: flash at every shape. On an H100, K3 took 10 to 125
      times less device time than the dense path at every shape the
      port's callers produce, from the audio tower's 4 windows of 104
      tokens to the decoder's prefill at B = 8 x 4736; at B >= 32 x 3168
      the dense path ran out of the card's memory
      (``scripts/attention_crossover.py``; PERF.md §6).
    - Otherwise (float32, the parity mode, where K3 is a CUDA-core
      kernel): by score BYTES (B*Hq*Sq*Sk*4), as in the JAX package:
      ASR_ATTN_THRESHOLD is the B=1-equivalent sequence length (default
      4096). This rule alone reads it.
    """
    from .kernels.flash_attention import HEAD_DIMS

    if not on_cuda or grad or head_dim not in HEAD_DIMS:
        return "dense"
    if dtype == torch.bfloat16:
        return "flash"
    threshold = int(os.environ.get("ASR_ATTN_THRESHOLD", "4096"))
    score_bytes = b * hq * sq * sk * 4
    limit_bytes = hq * threshold * threshold * 4
    return "flash" if score_bytes >= limit_bytes else "dense"


def dense_attention(q, k, v, *, mask=None, scale: float | None = None):
    """Multi-head (optionally grouped-query) scaled dot-product attention.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D) with Hq a multiple of Hkv.
    mask: optional additive mask broadcastable to (B, H, Sq, Sk), or a
    boolean mask of that shape (True = attend). Products accumulate in
    float32; probabilities round to v's dtype before the V contraction,
    as the JAX path does. Returns (B, Sq, Hq, D) in q.dtype.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    groups = hq // hkv
    if scale is None:
        scale = d ** -0.5

    qg = q.reshape(b, sq, hkv, groups, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.dtype == torch.bool:
            mask = torch.where(mask, 0.0, MASK_VALUE).float()
        # broadcast (., H, Sq, Sk) onto the grouped (B, Hkv, G, Sq, Sk)
        if mask.ndim == 4 and mask.shape[1] not in (1, hkv):
            mask = mask.reshape(mask.shape[0], hkv, groups, *mask.shape[2:])
        elif mask.ndim == 4:
            mask = mask[:, :, None]
        scores = scores + mask

    probs = torch.exp(scores - scores.amax(-1, keepdim=True))
    probs = probs / probs.sum(-1, keepdim=True)
    out = torch.einsum(
        "bhgqk,bkhd->bqhgd", probs.to(v.dtype).float(), v.float()
    )
    return out.reshape(b, sq, hq, d).to(q.dtype)


def attention(q, k, v, *, causal: bool = False, kv_valid=None,
              kv_start=None, scale: float | None = None,
              impl: str | None = None):
    """Structured-mask attention with implementation dispatch.

    q: (B, Sq, Hq, D); k, v: (B, Sk, Hkv, D).
    causal: query i attends keys j <= i (prefill).
    kv_valid: optional (B,) int tensor: keys >= kv_valid[b] are masked.
    kv_start: optional (B,) int tensor: keys < kv_start[b] are masked.
    impl: 'dense' | 'flash' | None (auto, ``auto_attention_impl``;
    ASR_ATTN_IMPL overrides). The flash kernel has no backward: forced to
    it while q, k or v needs a gradient, the call raises instead of
    detaching. Under the tracer (``utils/tracing.py``) each call adds 1
    to the counter ``attention.flash`` or ``attention.dense``.
    """
    if impl is None:
        impl = os.environ.get("ASR_ATTN_IMPL", "auto")
    if impl == "auto":
        impl = auto_attention_impl(
            q.shape[0], q.shape[2], q.shape[1], k.shape[1], q.is_cuda,
            dtype=q.dtype, head_dim=q.shape[3],
            grad=torch.is_grad_enabled() and any(
                t.requires_grad for t in (q, k, v)),
        )
    tracing.count(f"attention.{impl}", 1)
    if impl == "flash":
        from .kernels import forbid_backward
        from .kernels.flash_attention import flash_attention

        forbid_backward("K3 (flash_attention)", q, k, v)
        return flash_attention(q, k, v, kv_valid, kv_start, causal=causal,
                               scale=scale)
    if impl != "dense":
        raise ValueError(f"unknown attention impl {impl!r}")

    mask = None
    sq, sk = q.shape[1], k.shape[1]
    j = torch.arange(sk, device=q.device)[None, None, None, :]
    if kv_valid is not None:
        mask = torch.where(j < kv_valid[:, None, None, None], 0.0, MASK_VALUE)
    if kv_start is not None:
        sm = torch.where(j >= kv_start[:, None, None, None], 0.0, MASK_VALUE)
        mask = sm if mask is None else mask + sm
    if causal:
        i = torch.arange(sq, device=q.device)[:, None]
        cm = torch.where(j[0, 0] <= i, 0.0, MASK_VALUE)[None, None]
        mask = cm if mask is None else mask + cm
    return dense_attention(q, k, v, mask=mask, scale=scale)
