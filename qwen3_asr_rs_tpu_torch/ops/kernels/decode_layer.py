"""K1: one greedy decode step through all decoder layers.

Replaces the Pallas decode megakernel
``qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused`` in
its bf16/f32, unmerged, ``ffn_tiles=1``, no-fold, no-int8-KV branch, at
B = 1. One token goes through every layer (RMSNorm -> q/k/v -> QK-RMSNorm
-> rotary -> GQA attention over the slab's live range plus the fresh
self K/V -> o-proj + residual -> RMSNorm -> SwiGLU -> down + residual);
the step returns ``(h (B, H), ks, vs (L, B, Hkv, D))`` and the caller
writes ks/vs into the slab, as in JAX.

Kernel: ``csrc/decode_layer.cu``, one C entry that loops over the layers
and launches hand-written GEMVs (RMSNorm prologue; store, residual or
SwiGLU epilogue), a QK-norm + rotary kernel and K2's attention kernels
per layer. What bounds it on the H100 is the weight stream: at 0.6B bf16
28 x 15.7 M parameters, 0.88 GB per token, 0.26 ms at the data-sheet
3.35 TB/s. This first version is far from that bound: its 9 launches
per layer are each latency-bound (small GEMV grids, a chain of
dependent phases per launch), and enqueueing them takes the host more
than half as long as the device takes to run them (see PERF.md). The Pallas
kernel's VMEM budgets,
``ffn_tiles``, resident/DMA slab modes and 8/128 alignments are TPU
artifacts and are not carried over.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build
from .decode_attention import (
    _as_index,
    check_slabs,
    decode_attention,
    decode_attention_plain,
)

_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
_NORMS = ("input_ln_w", "post_ln_w", "q_norm_w", "k_norm_w")


def _rms(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.float()


def _mm(x, w):
    """(R, K) @ (K, N) with float32 accumulation of T products."""
    return x.float() @ w.float()


def decode_layers_fused_plain(x, cos, sin, layers, k_slabs, v_slabs, start,
                              end, *, eps: float):
    """Plain PyTorch version, rounding to x.dtype at the kernel's stages.

    x (B, H); cos/sin (B, D) float32; layers: stacked (L, ...) tree;
    k/v_slabs (L, B, Hkv, S, D); start (B,) int tensor or None; end (B,).
    Returns (h (B, H), ks (L, B, Hkv, D), vs (L, B, Hkv, D)).
    """
    cdt = x.dtype
    b = x.shape[0]
    nl, _, hkv, _, d = k_slabs.shape
    hq = layers["q_w"].shape[-1] // d
    half = d // 2
    cos_f, sin_f = cos.float()[:, None, :], sin.float()[:, None, :]

    def rope(t, heads):
        tf = t.float().reshape(b, heads, d)
        rot = torch.cat([-tf[..., half:], tf[..., :half]], -1)
        return (tf * cos_f + rot * sin_f).to(cdt)

    h = x
    ks, vs = [], []
    for l in range(nl):
        xn = _rms(h, layers["input_ln_w"][l], eps).to(cdt)
        q = _mm(xn, layers["q_w"][l]).to(cdt)
        k = _mm(xn, layers["k_w"][l]).to(cdt)
        v = _mm(xn, layers["v_w"][l]).to(cdt)
        q = _rms(q.reshape(b, hq, d), layers["q_norm_w"][l], eps).to(cdt)
        k = _rms(k.reshape(b, hkv, d), layers["k_norm_w"][l], eps).to(cdt)
        q, k = rope(q, hq), rope(k, hkv)
        v = v.reshape(b, hkv, d)
        attn = decode_attention_plain(q, k_slabs, v_slabs, k, v, l, start, end)
        o = _mm(attn.reshape(b, hq * d), layers["o_w"][l]).to(cdt)
        h = (h.float() + o.float()).to(cdt)
        xn2 = _rms(h, layers["post_ln_w"][l], eps).to(cdt)
        gate = _mm(xn2, layers["gate_w"][l]).to(cdt).float()
        up = _mm(xn2, layers["up_w"][l]).to(cdt)
        act = (gate * torch.sigmoid(gate)).to(cdt)
        down = _mm((act.float() * up.float()).to(cdt), layers["down_w"][l])
        h = (h.float() + down.to(cdt).float()).to(cdt)
        ks.append(k)
        vs.append(v)
    return h, torch.stack(ks), torch.stack(vs)


# Per (device, stream, dtype, dims, slab length): the step's float32
# workspace, its split-K counters (zero on entry, and the kernels leave
# them zero) and its T scratch, made once and reused by every step that is
# ordered on the same stream.
_scratch: dict = {}


def _lib():
    lib = _build.load("decode_layer")
    if not getattr(lib, "_bound", False):
        for fn in ("decode_layers_fused_bf16", "decode_layers_fused_f32"):
            _build.bind(lib, fn, 25, (ctypes.c_int,) * 7 + (ctypes.c_float,))
        lib.decode_layers_fused_scratch.argtypes = (
            [ctypes.c_int] * 6 + [ctypes.POINTER(ctypes.c_longlong)]
        )
        lib.decode_layers_fused_scratch.restype = None
        lib._bound = True
    return lib


def _check(x, cos, sin, layers, k_slabs, v_slabs):
    if x.ndim != 2 or x.shape[0] != 1:
        raise ValueError(
            "decode_layers_fused: the CUDA step takes B = 1 "
            f"(got x {tuple(x.shape)}); batched decode is not ported yet"
        )
    missing = [n for n in _WEIGHTS + _NORMS if n not in layers]
    extra = [n for n in layers if n not in _WEIGHTS + _NORMS]
    if missing or extra:
        raise ValueError(
            "decode_layers_fused: takes unmerged float weights only "
            f"(missing {missing}, unsupported {extra})"
        )
    nl, b, hkv, _, d = k_slabs.shape
    h = x.shape[1]
    hq = layers["q_w"].shape[-1] // d
    inter = layers["gate_w"].shape[-1]
    want = {
        "q_w": (nl, h, hq * d), "k_w": (nl, h, hkv * d),
        "v_w": (nl, h, hkv * d), "o_w": (nl, hq * d, h),
        "gate_w": (nl, h, inter), "up_w": (nl, h, inter),
        "down_w": (nl, inter, h), "input_ln_w": (nl, h),
        "post_ln_w": (nl, h), "q_norm_w": (nl, d), "k_norm_w": (nl, d),
    }
    for n, shape in want.items():
        t = layers[n]
        if tuple(t.shape) != shape or t.dtype != x.dtype or (
            t.device != x.device or not t.is_contiguous()
        ):
            raise ValueError(
                f"decode_layers_fused: {n} must be a contiguous {shape} "
                f"{x.dtype} tensor on {x.device}, got {tuple(t.shape)} "
                f"{t.dtype} on {t.device}"
            )
    if h % 8 or inter % 8:
        raise ValueError("decode_layers_fused: H and I must be multiples of 8")
    for t in (cos, sin):
        if t.shape != (b, d) or t.dtype != torch.float32 or (
            t.device != x.device or not t.is_contiguous()
        ):
            raise ValueError("decode_layers_fused: cos/sin must be (B, D) f32")
    check_slabs(k_slabs, v_slabs, b, hq, d, x.dtype, x.device)
    if not x.is_contiguous():
        raise ValueError("decode_layers_fused: x must be contiguous")
    return nl, h, hq, hkv, d, inter


def decode_layers_fused(x, cos, sin, layers, k_slabs, v_slabs, start, end,
                        *, eps: float):
    """One decode step through all layers (see module docstring).

    ``start`` (None, int or (B,) tensor) and ``end`` (int or (B,) tensor)
    bound the live slab slots. CPU tensors run
    ``decode_layers_fused_plain``; CUDA tensors launch the kernel
    (``decode_layers_fused.launches`` counts those launches).
    """
    b = x.shape[0]
    if x.device.type == "cpu":
        return decode_layers_fused_plain(
            x, cos, sin, layers, k_slabs, v_slabs,
            None if start is None else _as_index(start, b, x.device),
            _as_index(end, b, x.device), eps=eps,
        )
    if x.device.type != "cuda":
        raise ValueError(f"decode_layers_fused: device {x.device} not supported")
    nl, h, hq, hkv, d, inter = _check(x, cos, sin, layers, k_slabs, v_slabs)
    s_max = k_slabs.shape[3]
    start_t = _as_index(0 if start is None else start, b, x.device)
    end_t = _as_index(end, b, x.device)
    stream = _build.stream_of(x)
    lib = _lib()
    key = (x.device, stream.value, x.dtype, h, hq, hkv, d, inter, s_max)
    if key not in _scratch:
        sizes = (ctypes.c_longlong * 3)()
        lib.decode_layers_fused_scratch(h, hq, hkv, d, inter, s_max, sizes)
        _scratch[key] = (
            torch.empty(sizes[0], dtype=torch.float32, device=x.device),
            torch.zeros(sizes[1], dtype=torch.int32, device=x.device),
            torch.empty(sizes[2], dtype=x.dtype, device=x.device),
        )
    ws, counters, tmp = _scratch[key]
    h_out = torch.empty_like(x)
    ks = torch.empty((nl, b, hkv, d), dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    attn_launches = ctypes.c_int(0)
    fn = (lib.decode_layers_fused_bf16 if x.dtype == torch.bfloat16
          else lib.decode_layers_fused_f32)
    p = _build.ptr
    rc = fn(p(x), p(cos), p(sin),
            *(p(layers[n]) for n in _NORMS),
            *(p(layers[n]) for n in _WEIGHTS),
            p(k_slabs), p(v_slabs), p(start_t), p(end_t),
            p(h_out), p(ks), p(vs), p(ws), p(counters), p(tmp),
            ctypes.addressof(attn_launches),
            nl, h, hq, hkv, d, inter, s_max, eps, stream)
    decode_attention.launches += attn_launches.value
    if rc != 0:
        # a failed launch may leave the split-K counters nonzero
        del _scratch[key]
    _build.check(lib, rc, "decode_layers_fused")
    decode_layers_fused.launches += 1
    return h_out, ks, vs


decode_layers_fused.launches = 0
