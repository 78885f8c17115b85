"""K3: online-softmax ("flash") attention for long prefills.

Replaces the Pallas kernel
``qwen3_asr_rs_tpu/ops/pallas/flash_attention.py::flash_attention``:
causal, ``kv_valid`` and ``kv_start`` masks, GQA h -> h // G, and the
(Sq, Sk) score matrix is never written to device memory.

Kernel: ``csrc/flash_attention.cu`` (see the note there). What bounds it
on the H100 is arithmetic: a causal 4736-token prefill at 16 heads and
D = 128 is ~92 GFLOP per layer. bf16 inputs run both products on the
tensor cores (``mma.sync`` with bf16 K/V tiles streamed by ``cp.async``
into swizzled shared memory, P fed from the score registers to the PV
product); float32 inputs, the parity mode, keep float32 products on the
CUDA cores. ``ops/attention.py::auto_attention_impl`` sends every bf16
call here that needs no gradient (the crossover measured on the card),
and float32 calls by the JAX package's score-bytes rule.

Rows with no attendable key come out finite (as in the Pallas kernel);
their values differ between the kernel and the plain version and
callers discard them.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, counted

HEAD_DIMS = (64, 128)  # the head sizes the kernel takes


def flash_attention_plain(q, k, v, kv_valid=None, kv_start=None, *,
                          causal: bool = False, scale: float | None = None):
    """Plain PyTorch version: the masked dense attention of
    ``ops/attention.py`` (float32 scores, -1e9 masks)."""
    from ..attention import attention

    return attention(q, k, v, causal=causal, kv_valid=kv_valid,
                     kv_start=kv_start, scale=scale, impl="dense")


def flash_attention_tile_reference(q, k, v, kv_valid=None, kv_start=None, *,
                                   causal: bool = False,
                                   scale: float | None = None,
                                   block_k: int = 64):
    """The arithmetic of K3's bf16 kernel (and of the Pallas kernel at
    ``block_k``) in its key-tile order, in float32 and unrounded at the
    end: per example the tiles of ``block_k`` keys from kv_start's tile
    to the last one below kv_valid, scores of the inputs in float32 times
    scale, masked to -1e9, a running max from -1e30, the softmax sum of
    the float32 P, the PV product of P rounded to v's dtype per tile, one
    division at the end. A tile that is wholly masked for a row once the
    row has a live key adds exactly nothing, so the kernel's per-block
    stop at the diagonal needs no emulation. Returns float32
    (B, Sq, Hq, D); the kernel's output is this rounded to its dtype,
    which is what per-element checks hold it to."""
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5 if scale is None else scale
    out = torch.empty((b, sq, hq, d), dtype=torch.float32, device=q.device)
    rows = torch.arange(sq, device=q.device)[:, None]
    for bi in range(b):
        valid = sk if kv_valid is None else min(int(kv_valid[bi]), sk)
        kbegin = 0 if kv_start is None else max(int(kv_start[bi]), 0)
        qf = q[bi].float().transpose(0, 1)  # (Hq, Sq, D)
        kf, vf = (x[bi].transpose(0, 1).repeat_interleave(g, 0)
                  for x in (k, v))          # (Hq, Sk, D)
        m = torch.full((hq, sq), -1e30, device=q.device)
        l = torch.zeros((hq, sq), device=q.device)
        acc = torch.zeros((hq, sq, d), device=q.device)
        for k0 in range(kbegin // block_k * block_k, valid, block_k):
            k1 = min(k0 + block_k, sk)
            cols = torch.arange(k0, k1, device=q.device)[None, :]
            s = qf @ kf[:, k0:k1].float().transpose(1, 2) * scale
            bad = (cols >= valid) | (cols < kbegin)
            if causal:
                bad = bad | (cols > rows)
            s = torch.where(bad, -1e9, s)
            mn = torch.maximum(m, s.amax(-1))
            corr = torch.exp(m - mn)
            p = torch.exp(s - mn[..., None])
            l = l * corr + p.sum(-1)
            acc = (acc * corr[..., None]
                   + p.to(v.dtype).float() @ vf[:, k0:k1].float())
            m = mn
        out[bi] = (acc / torch.clamp(l, min=1e-30)[..., None]).transpose(0, 1)
    return out


def _lib():
    lib = _build.load("flash_attention")
    if not getattr(lib, "_bound", False):
        for fn in ("flash_attention_bf16", "flash_attention_f32"):
            _build.bind(lib, fn, 6,
                        (ctypes.c_int,) * 6 + (ctypes.c_float, ctypes.c_int))
        lib._bound = True
    return lib


def _index_or_none(x, b: int, device):
    if x is None:
        return None
    t = x.to(device=device, dtype=torch.int32).contiguous()
    if t.shape != (b,):
        raise ValueError(f"flash_attention: mask lengths must be ({b},)")
    return t


@counted
def flash_attention(q, k, v, kv_valid=None, kv_start=None, *,
                    causal: bool = False, scale: float | None = None):
    """q (B, Sq, Hq, D); k, v (B, Sk, Hkv, D); kv_valid/kv_start (B,)
    int tensors or None. Returns (B, Sq, Hq, D) in q.dtype.

    CPU tensors run ``flash_attention_plain``; CUDA tensors launch the
    kernel (``flash_attention.launches`` counts those launches).
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, kv_valid, kv_start,
                                     causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: device {q.device} not supported")
    b, sq, hq, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError("flash_attention: k, v must be (B, Sk, Hkv, D)")
    _, sk, hkv, _ = k.shape
    if q.dtype not in (torch.bfloat16, torch.float32) or d not in HEAD_DIMS:
        raise ValueError(
            f"flash_attention: kernel takes bf16/f32 and head_dim in "
            f"{HEAD_DIMS}, got {q.dtype}, D={d}"
        )
    if hq % hkv:
        raise ValueError("flash_attention: Hq must be a multiple of Hkv")
    for t in (q, k, v):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                "flash_attention: q, k, v must share dtype and device and "
                "be contiguous"
            )
    scale = d ** -0.5 if scale is None else scale
    if q.dtype == torch.bfloat16 and not scale > 0:
        raise ValueError("flash_attention: the bf16 kernel takes scale > 0")
    valid_t = _index_or_none(kv_valid, b, q.device)
    start_t = _index_or_none(kv_start, b, q.device)
    out = torch.empty_like(q)
    lib = _lib()
    fn = (lib.flash_attention_bf16 if q.dtype == torch.bfloat16
          else lib.flash_attention_f32)
    p = _build.ptr
    rc = fn(p(q), p(k), p(v),
            None if valid_t is None else p(valid_t),
            None if start_t is None else p(start_t),
            p(out), b, sq, sk, hq, hkv, d, scale, int(causal),
            _build.stream_of(q))
    _build.check(lib, rc, "flash_attention")
    flash_attention.launches += 1
    return out
