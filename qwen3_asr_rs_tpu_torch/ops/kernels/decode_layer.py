"""K1: one greedy decode step through all decoder layers, for B rows.

Replaces the Pallas decode megakernel
``qwen3_asr_rs_tpu/ops/pallas/decode_layer.py::decode_layers_fused``
in its ``ffn_tiles=1`` branches at any B >= 1 (per-row ``start`` and
cos/sin, a shared ``end``), for bf16/f32 activations; float, int8
(``*_q`` + per-column ``*_s``), int4 (``*_q4`` + ``*_s``, nibble-packed:
packed column j holds columns j and j + N/2) or group-wise int4 (int4g:
``*_q4`` + ``(L, G, N)`` float32 ``*_s``, one scale per group of
contraction rows and column, merged layout only, as in JAX) weights, in
the merged layout (``qkv_w``, ``o_w``, ``gateup_w``, ``down_w``) or per
projection; and slabs in the compute dtype or int8 with per-slot float32
``k_scales``/``v_scales`` (the int8-KV mode). Each row goes through every
layer (RMSNorm -> q/k/v -> QK-RMSNorm -> rotary -> GQA attention over
the row's live slab range plus the fresh self K/V -> o-proj + residual
-> RMSNorm -> SwiGLU -> down + residual); the step returns ``(h (B, H),
ks, vs (L, B, Hkv, D))`` in the compute dtype and the caller writes
(and for an int8 slab quantizes) ks/vs into the slab, as in JAX. Every
product accumulates in float32; a per-column scale multiplies the whole
sum, a group scale each group's float32 partial before the groups are
summed, and the result then rounds to the compute dtype, as the Pallas
kernel's ``_mm`` does. Attention is K2's device code: int8 slab scales
fold into the scores and probabilities (``decode_attention.py``), where
the Pallas megakernel dequantizes K/V to the compute dtype first; the
two agree exactly in float32 up to the order of two products.

``fold_lm=True`` (the engine's ``ASR_FOLD_LM=1``) runs, after the last
layer, the final RMSNorm (the normed row rounded to the compute dtype),
the lm_head product with float32 logits (a ``(V, H)`` lm_head in the
compute dtype, or int8 ``(H, V)`` with per-column ``lm_scales`` applied
to the float32 sum) and the argmax over all V columns, ties to the
lowest index as ``jnp.argmax``; the step then returns ``(token_ids (B,)
int32, ks, vs)``. The lm_head is read where it lies: the Pallas
kernel's padded, transposed copy (``prepare_lm_fold``) is a TPU layout.

Kernel: ``csrc/decode_layer.cu``, one C entry that loops over the layers
and launches hand-written GEMVs templated on the weight kind (RMSNorm
prologue; store, residual or SwiGLU epilogue), a QK-norm + rotary kernel
and K2's attention kernel per layer: 6 launches per layer in every layout
(unmerged q/k/v are one launch over three column segments), then the
folded lm_head and argmax. What bounds it on the H100 is the weight
stream: at 0.6B 28 x 15.7 M parameters, 0.88 GB per step in bf16, 0.44
GB in int8, 0.22 GB in int4 (0.26 / 0.13 / 0.07 ms at the data-sheet
3.35 TB/s; int4g adds 1/16 of the int4 bytes in scales at group size
128), plus 311 / 156 MB for a folded bf16 / int8 lm_head, which the
GEMVs read once per step for up to 32 rows. With bf16 activations the
GEMVs run on the tensor cores, launched with programmatic dependent
launch between the kernels of a layer: bf16 weights (``gemv_route``) on
the wgmma GEMV (``csrc/gemv_wgmma.cuh``: a TMA ring of weight tiles,
``wgmma`` with the batch rows as N, K split across a thread-block
cluster as ``gemv_wgmma_plan`` says and summed in rank order in shared
memory; its launches counted by ``gemv_wgmma``), the rest on the
mma.sync GEMV (``csrc/gemv_mma.cuh``: int8/int4 weights converted
exactly, 16-byte ``cp.async`` rings, a K split from the shapes and B
(``gemv_split_rows``) summed through a global workspace); float32
activations keep CUDA-core GEMVs (the parity path). ``gemv_single``
launches one such GEMV alone, for the card checks. The Pallas kernel's
VMEM budgets, ``ffn_tiles``, resident/DMA slab modes, scale-row packing
and 8/128 alignments are TPU scheduling and are not carried over.
"""

from __future__ import annotations

import ctypes
from types import SimpleNamespace

import torch

from ..quant import (
    dequantize_int4_grouped,
    int4_grouped_partials,
    int4_matmul_plain,
    unpack_int4,
)
from . import _build, counted
from .decode_attention import (
    _as_index,
    check_slabs,
    decode_attention_dma,
    decode_attention_dma_plain,
)
from .quant_matmul import quant_matmul_plain

_WEIGHTS = ("q_w", "k_w", "v_w", "o_w", "gate_w", "up_w", "down_w")
_MERGED_WEIGHTS = ("qkv_w", "o_w", "gateup_w", "down_w")
_NORMS = ("input_ln_w", "post_ln_w", "q_norm_w", "k_norm_w")
# weight kind codes of the C entry (csrc/decode_layer.cu, WeightKind)
_KINDS = {"": 0, "_q": 1, "_q4": 2, "_q4g": 3}
# lm_head fold codes of the C entry (FoldKind): none, (V, H) in the
# compute dtype, int8 (H, V) with per-column scales
_FOLD_NONE, _FOLD_ROWS, _FOLD_INT8 = 0, 1, 2


def _layout(layers):
    """(weight-name suffix '' | '_q' | '_q4', merged) of a layer tree."""
    merged = "qkv_w_q" in layers or "qkv_w_q4" in layers
    for suffix in ("_q4", "_q"):
        if f"{'qkv_w' if merged else 'q_w'}{suffix}" in layers:
            return suffix, merged
    return "", merged


def is_grouped(layers) -> bool:
    """Whether a layer tree holds group-wise int4 weights (int4g): 3-D
    ``(L, G, N)`` scales beside ``*_q4``."""
    return any(n.endswith("_s") and t.ndim == 3 for n, t in layers.items())


def int4g_group_supported(group_size: int, ks=()) -> bool:
    """Group sizes the CUDA kernel takes: 32 and 64 (a group spans one or
    two of a GEMV thread's 32-row stripes) and multiples of 128 (a GEMV
    block's 128-row K slice lies in one group), dividing every K in ``ks``
    (the quantizer would clamp the group of a K it does not divide)."""
    return (group_size in (32, 64) or (group_size > 0 and group_size % 128 == 0)
            ) and not any(k % group_size for k in ks)


def _rms(x, w, eps):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    return xf * torch.rsqrt(var + eps) * w.float()


def _mm(x, layers, name: str, l: int, cdt):
    """x (R, K) @ layer ``l`` of weight ``name`` -> cdt: float32
    accumulation of x's values times the float, int8 or int4 weights, a
    per-column scale applied to the whole sum or group scales to each
    group's partial, one rounding."""
    if f"{name}_q4" in layers:
        s = layers[f"{name}_s"][l]
        if s.ndim == 2:  # int4g: (G, N) scales
            return int4_grouped_partials(x, layers[f"{name}_q4"][l], s).to(cdt)
        return int4_matmul_plain(x, layers[f"{name}_q4"][l], s, out_dtype=cdt)
    if f"{name}_q" in layers:
        return quant_matmul_plain(x, layers[f"{name}_q"][l],
                                  layers[f"{name}_s"][l], out_dtype=cdt)
    return (x.float() @ layers[name][l].float()).to(cdt)


def lm_fold_plain(h, final_ln_w, lm_head, lm_scales, eps: float):
    """The folded lm_head of the plain version: final RMSNorm of h (B, H)
    rounded to h's dtype, float32 logits against a (V, H) lm_head (in
    h's dtype) or an int8 (H, V) one times ``lm_scales``, and their
    argmax (ties to the lowest index) as (B,) int32."""
    xn = _rms(h, final_ln_w, eps).to(h.dtype)
    if lm_head.dtype == torch.int8:
        logits = quant_matmul_plain(xn, lm_head, lm_scales,
                                    out_dtype=torch.float32)
    else:
        logits = xn.float() @ lm_head.to(h.dtype).float().T
    return torch.argmax(logits, -1).to(torch.int32)


def decode_layers_fused_plain(x, cos, sin, layers, k_slabs, v_slabs, start,
                              end, *, eps: float, k_scales=None,
                              v_scales=None, fold_lm: bool = False,
                              final_ln_w=None, lm_head=None, lm_scales=None):
    """Plain PyTorch version, rounding to x.dtype at the kernel's stages.

    x (B, H); cos/sin (B, D) float32; layers: stacked (L, ...) tree of
    float, int8, int4 or int4g weights, merged or per projection;
    k/v_slabs (L, B, Hkv, S, D), int8 with ``k_scales``/``v_scales``
    (L, B, Hkv, S) float32; start (B,) int tensor or None; end (B,).
    Returns (h (B, H), ks (L, B, Hkv, D), vs (L, B, Hkv, D)), or with
    ``fold_lm`` (token ids (B,) int32, ks, vs).
    """
    cdt = x.dtype
    b = x.shape[0]
    nl, _, hkv, _, d = k_slabs.shape
    merged = _layout(layers)[1]
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
        if merged:
            qkv = _mm(xn, layers, "qkv_w", l, cdt)
            q, k, v = qkv.split([qkv.shape[-1] - 2 * hkv * d, hkv * d,
                                 hkv * d], -1)
        else:
            q, k, v = (_mm(xn, layers, n, l, cdt) for n in ("q_w", "k_w", "v_w"))
        hq = q.shape[-1] // d
        q = _rms(q.reshape(b, hq, d), layers["q_norm_w"][l], eps).to(cdt)
        k = _rms(k.reshape(b, hkv, d), layers["k_norm_w"][l], eps).to(cdt)
        q, k = rope(q, hq), rope(k, hkv)
        v = v.reshape(b, hkv, d)
        attn = decode_attention_dma_plain(q, k_slabs, v_slabs, k, v, l, start,
                                          end, k_scales=k_scales,
                                          v_scales=v_scales)
        o = _mm(attn.reshape(b, hq * d), layers, "o_w", l, cdt)
        h = (h.float() + o.float()).to(cdt)
        xn2 = _rms(h, layers["post_ln_w"][l], eps).to(cdt)
        if merged:
            gate, up = _mm(xn2, layers, "gateup_w", l, cdt).chunk(2, -1)
        else:
            gate = _mm(xn2, layers, "gate_w", l, cdt)
            up = _mm(xn2, layers, "up_w", l, cdt)
        gate = gate.float()
        act = (gate * torch.sigmoid(gate)).to(cdt)
        down = _mm((act.float() * up.float()).to(cdt), layers, "down_w", l,
                   cdt)
        h = (h.float() + down.float()).to(cdt)
        ks.append(k)
        vs.append(v)
    if fold_lm:
        h = lm_fold_plain(h, final_ln_w, lm_head, lm_scales, eps)
    return h, torch.stack(ks), torch.stack(vs)


# Per (device, stream, dtype, rows, dims, slab length, int4g group size,
# folded vocabulary): the step's float32
# workspace (its tail holds K2's fold counters), its split-K counters (all
# counters zero on entry, and the kernels leave them zero), its T scratch
# and the folded argmax's (B,) 64-bit keys (zero on entry and left zero),
# made once and reused by every step that is ordered on the same stream.
_scratch: dict = {}


def _lib():
    lib = _build.load("decode_layer")
    if not getattr(lib, "_bound", False):
        for fn in ("decode_layers_fused_bf16", "decode_layers_fused_f32"):
            f = getattr(lib, fn)
            f.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                           ctypes.c_void_p] + [ctypes.c_int] * 11
                          + [ctypes.c_float, ctypes.c_void_p])
            f.restype = ctypes.c_int
        lib.decode_layers_fused_scratch.argtypes = (
            [ctypes.c_int] * 9 + [ctypes.POINTER(ctypes.c_longlong)]
        )
        lib.decode_layers_fused_scratch.restype = None
        lib.gemv_single_bf16.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
            + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int]
            + [ctypes.c_void_p] * 2)
        lib.gemv_single_bf16.restype = ctypes.c_int
        lib.gemv_wgmma_plan.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.gemv_wgmma_plan.restype = None
        lib.gemv_route.argtypes = [ctypes.c_int] * 5
        lib.gemv_route.restype = ctypes.c_int
        lib.gemv_single_ws_words.argtypes = [ctypes.c_int] * 3
        lib.gemv_single_ws_words.restype = ctypes.c_longlong
        lib.gemv_split_rows.argtypes = [ctypes.c_int] * 7
        lib.gemv_split_rows.restype = ctypes.c_int
        lib._bound = True
    return lib


def _check_tensor(name, t, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype or (
        t.device != device or not t.is_contiguous()
    ):
        raise ValueError(
            f"decode_layers_fused: {name} must be a contiguous {shape} "
            f"{dtype} tensor on {device}, got {tuple(t.shape)} {t.dtype} "
            f"on {t.device}"
        )


def _check(x, cos, sin, layers, k_slabs, v_slabs, k_scales, v_scales):
    """Validate the operands of the CUDA step; returns (kind, merged,
    group size (0 unless int4g), nl, h, hq, hkv, d, inter)."""
    if x.ndim != 2 or x.shape[0] < 1:
        raise ValueError(
            f"decode_layers_fused: x must be (B, H), got {tuple(x.shape)}")
    suffix, merged = _layout(layers)
    names = _MERGED_WEIGHTS if merged else _WEIGHTS
    expected = {n + suffix for n in names} | set(_NORMS)
    if suffix:
        expected |= {f"{n}_s" for n in names}
    missing = sorted(expected - set(layers))
    extra = sorted(set(layers) - expected)
    if missing or extra:
        raise ValueError(
            "decode_layers_fused: takes float, int8, int4 or int4g weights, "
            f"merged or per projection (missing {missing}, unsupported "
            f"{extra})"
        )
    b, h = x.shape
    nl, _, hkv, _, d = k_slabs.shape
    pack = 2 if suffix == "_q4" else 1  # logical columns per stored one
    if merged:
        hq = (layers["qkv_w" + suffix].shape[-1] * pack - 2 * hkv * d) // d
        inter = layers["gateup_w" + suffix].shape[-1] * pack // 2
        widths = {"qkv_w": (h, (hq + 2 * hkv) * d), "gateup_w": (h, 2 * inter)}
    else:
        hq = layers["q_w" + suffix].shape[-1] * pack // d
        inter = layers["gate_w" + suffix].shape[-1] * pack
        widths = {"q_w": (h, hq * d), "k_w": (h, hkv * d), "v_w": (h, hkv * d),
                  "gate_w": (h, inter), "up_w": (h, inter)}
    widths.update({"o_w": (hq * d, h), "down_w": (inter, h)})
    gsize = 0
    if suffix == "_q4" and is_grouped(layers):
        if not merged:
            raise ValueError(
                "decode_layers_fused: grouped int4 scales need the merged "
                "layout (ASR_MERGE_QKV=0 runs the per-layer decode path)")
        gsize = h // layers["qkv_w_s"].shape[1]
        if not int4g_group_supported(gsize, [k for k, _ in widths.values()]):
            raise ValueError(
                f"decode_layers_fused: int4 group size {gsize} not supported "
                "(32, 64 or a multiple of 128 dividing every K)")
    want = {n + suffix: ((nl, k, n_out // pack),
                         torch.int8 if suffix else x.dtype)
            for n, (k, n_out) in widths.items()}
    if suffix:
        want.update({f"{n}_s": ((nl, k // gsize, n_out) if gsize
                                else (nl, n_out), torch.float32)
                     for n, (k, n_out) in widths.items()})
    want.update({"input_ln_w": ((nl, h), x.dtype), "post_ln_w": ((nl, h), x.dtype),
                 "q_norm_w": ((nl, d), x.dtype), "k_norm_w": ((nl, d), x.dtype)})
    for n, (shape, dtype) in want.items():
        _check_tensor(n, layers[n], shape, dtype, x.device)
    # the GEMVs copy whole 16-byte chunks of a weight row
    align = {"": 8, "_q": 16, "_q4": 32}[suffix]
    if h % align or inter % align or (hq * d) % align or (hkv * d) % align:
        raise ValueError(
            f"decode_layers_fused: H, I, Hq * D and Hkv * D must be "
            f"multiples of {align}")
    for t in (cos, sin):
        if t.shape != (b, d) or t.dtype != torch.float32 or (
            t.device != x.device or not t.is_contiguous()
        ):
            raise ValueError("decode_layers_fused: cos/sin must be (B, D) f32")
    check_slabs(k_slabs, v_slabs, b, hq, d, x.dtype, x.device, k_scales,
                v_scales)
    if not x.is_contiguous():
        raise ValueError("decode_layers_fused: x must be contiguous")
    kind = "_q4g" if gsize else suffix
    return kind, merged, gsize, nl, h, hq, hkv, d, inter


def _check_fold(x, final_ln_w, lm_head, lm_scales):
    """Validate the folded lm_head's operands; returns (fold code, V)."""
    h = x.shape[1]
    _check_tensor("final_ln_w", final_ln_w, (h,), x.dtype, x.device)
    if lm_head is None or lm_head.ndim != 2:
        raise ValueError("decode_layers_fused: fold_lm needs a 2-D lm_head")
    if lm_head.dtype == torch.int8:
        v = lm_head.shape[1]
        _check_tensor("lm_head", lm_head, (h, v), torch.int8, x.device)
        if lm_scales is None:
            raise ValueError("decode_layers_fused: an int8 lm_head needs "
                             "lm_scales")
        _check_tensor("lm_scales", lm_scales, (v,), torch.float32, x.device)
        if v % 16:
            raise ValueError("decode_layers_fused: the int8 lm_head's V must "
                             "be a multiple of 16")
        return _FOLD_INT8, v
    v = lm_head.shape[0]
    _check_tensor("lm_head", lm_head, (v, h), x.dtype, x.device)
    if lm_scales is not None:
        raise ValueError("decode_layers_fused: lm_scales go with an int8 "
                         "lm_head only")
    return _FOLD_ROWS, v


@counted
def decode_layers_fused(x, cos, sin, layers, k_slabs, v_slabs, start, end,
                        *, eps: float, k_scales=None, v_scales=None,
                        fold_lm: bool = False, final_ln_w=None, lm_head=None,
                        lm_scales=None):
    """One decode step through all layers (see module docstring).

    ``start`` (None, int or (B,) tensor) and ``end`` (int or (B,) tensor;
    a tensor while a CUDA graph is captured) bound each row's live slab
    slots; ``k_scales``/``v_scales`` go with
    int8 slabs; ``fold_lm`` with ``final_ln_w`` (H,), ``lm_head`` ((V, H)
    in x's dtype, or int8 (H, V)) and ``lm_scales`` ((V,) float32, int8
    only) returns token ids instead of hidden states. CPU tensors run
    ``decode_layers_fused_plain``; CUDA tensors launch the kernel
    (``decode_layers_fused.launches`` counts those launches).
    """
    b = x.shape[0]
    if x.device.type == "cpu":
        return decode_layers_fused_plain(
            x, cos, sin, layers, k_slabs, v_slabs,
            None if start is None else _as_index(start, b, x.device),
            _as_index(end, b, x.device), eps=eps, k_scales=k_scales,
            v_scales=v_scales, fold_lm=fold_lm, final_ln_w=final_ln_w,
            lm_head=lm_head, lm_scales=lm_scales,
        )
    if x.device.type != "cuda":
        raise ValueError(f"decode_layers_fused: device {x.device} not supported")
    kind, merged, gsize, nl, h, hq, hkv, d, inter = _check(
        x, cos, sin, layers, k_slabs, v_slabs, k_scales, v_scales)
    fold, vocab = (_check_fold(x, final_ln_w, lm_head, lm_scales) if fold_lm
                   else (_FOLD_NONE, 0))
    s_max = k_slabs.shape[3]
    _build.check_not_frozen("decode_layers_fused: end", end)
    start_t = _as_index(0 if start is None else start, b, x.device)
    end_t = _as_index(end, b, x.device)
    stream = _build.stream_of(x)
    lib = _lib()
    key = (x.device, stream.value, x.dtype, b, h, hq, hkv, d, inter, s_max,
           gsize, vocab)
    if key not in _scratch:
        sizes = (ctypes.c_longlong * 3)()
        lib.decode_layers_fused_scratch(b, h, hq, hkv, d, inter, s_max, gsize,
                                        vocab, sizes)
        _scratch[key] = (
            torch.zeros(sizes[0], dtype=torch.float32, device=x.device),
            torch.zeros(sizes[1], dtype=torch.int32, device=x.device),
            torch.empty(sizes[2], dtype=x.dtype, device=x.device),
            torch.zeros(b, dtype=torch.int64, device=x.device),
        )
    ws, counters, tmp, best = _scratch[key]
    h_out = torch.empty_like(x)
    tok = torch.empty(b, dtype=torch.int32, device=x.device) if fold else None
    ks = torch.empty((nl, b, hkv, d), dtype=x.dtype, device=x.device)
    vs = torch.empty_like(ks)
    # the C entry's pointer table (csrc/decode_layer.cu, enum StepPtr)
    suffix = "_q4" if gsize else kind
    names = _MERGED_WEIGHTS if merged else _WEIGHTS
    slot = {"qkv_w": "q_w", "gateup_w": "gate_w"}
    weights = dict.fromkeys(_WEIGHTS)
    scales = dict.fromkeys(_WEIGHTS)
    for n in names:
        weights[slot.get(n, n)] = layers[n + suffix]
        scales[slot.get(n, n)] = layers.get(f"{n}_s") if suffix else None
    tensors = ([x, cos, sin] + [layers[n] for n in _NORMS]
               + [k_slabs, v_slabs, start_t, end_t, h_out, ks, vs, ws,
                  counters, tmp]
               + [weights[n] for n in _WEIGHTS] + [scales[n] for n in _WEIGHTS]
               + [k_scales, v_scales]
               + ([final_ln_w, lm_head, lm_scales, best, tok] if fold
                  else [None] * 5))
    table = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    # K2's launches and the wgmma GEMV's, counted by the C entry
    launches = (ctypes.c_int * 2)()
    fn = (lib.decode_layers_fused_bf16 if x.dtype == torch.bfloat16
          else lib.decode_layers_fused_f32)
    rc = fn(table, _KINDS[kind], int(merged), ctypes.addressof(launches),
            nl, b, h, hq, hkv, d, inter, s_max, gsize, fold, vocab, eps,
            stream)
    decode_attention_dma.launches += launches[0]
    gemv_wgmma.launches += launches[1]
    if rc != 0:
        # a failed launch may leave the split-K counters or keys nonzero
        del _scratch[key]
    _build.check(lib, rc, "decode_layers_fused")
    decode_layers_fused.launches += 1
    return (tok if fold else h_out), ks, vs


# The wgmma GEMV's launches: it has no wrapper of its own (it runs inside
# K1's step and ``gemv_single``, whose wrappers add the C entries' counts
# here); counted, so that replays add theirs too.
gemv_wgmma = counted(SimpleNamespace())


# ---- the tensor-core GEMV alone (card checks) ---------------------------

# gm_split_rows's constants (csrc/gemv_mma.cuh)
GEMV_KS = 64              # weight rows per stage (the split granule)
GEMV_TN = 64              # loaded columns per block
GEMV_TARGET_BLOCKS = 264  # two blocks per SM of the H100 SXM
GEMV_EPI_ROWS = 256       # rows x splits of a last block's reduction
GEMV_XS_MAX = 68 * 1024   # bytes of staged x rows
_EPILOGUES = {"store": 0, "residual": 1, "swiglu": 2}
# launch_gemv's routes (csrc/decode_layer.cu, GemvRoute)
_ROUTES = {"rule": -1, "mma": 0, "wgmma": 1}


def gemv_split_rows(k: int, tiles: int, rows: int, nacc: int, wbytes: int,
                    granule: int, nb8: int) -> int:
    """Rows of K per block of a tensor-core GEMV (``gm_split_rows``): a
    multiple of ``granule`` with as many splits as keep tiles x splits
    within GEMV_TARGET_BLOCKS (one round of the SMs), but no more than
    keeps the split-K partials (rows x nacc float32 per loaded column and
    split) within the weight bytes they sum (``wbytes`` per loaded column
    and K row) and rows x splits within GEMV_EPI_ROWS, and no more K than
    GEMV_XS_MAX bytes of 8 * nb8 staged bf16 rows hold."""
    units = -(-k // granule)
    want = max(1, GEMV_TARGET_BLOCKS // tiles)
    steps = -(-units // want)
    steps = max(steps, -(-(-(-4 * rows * nacc // wbytes)) // granule),
                -(-units // max(1, GEMV_EPI_ROWS // rows)))
    steps = min(steps, (GEMV_XS_MAX // (16 * nb8) - 8) // granule, units)
    return max(steps, 1) * granule


# gw_plan's and gw_route's constants (csrc/gemv_wgmma.cuh)
GW_KS = 64                 # weight rows per stage
GW_TN = 64                 # weight columns per block: wgmma's M
GW_W_BYTES = GW_KS * GW_TN * 2  # one source's weight tile
GW_MAX_CLUSTER = 8         # the portable cluster size
GW_SMS = 132               # SMs of the H100 SXM
GW_TARGET_BLOCKS = 2 * GW_SMS  # blocks a launch may take
GW_SM_SMEM = 228 * 1024    # shared memory of an SM
GW_BLOCK_EXTRA = 1024 + 128  # a block's reserve and static bytes
GW_SMEM_MAX = 227 * 1024 - 128
GW_MAX_STAGES = 4
GW_RPITCH = GW_TN + 4      # floats per row of the partials
GW_SLACK = 1024 + 128


def gemv_nb8(rows: int) -> int:
    """Staged rows of a tensor-core GEMV of ``rows`` rows, in 8s."""
    return 1 if rows <= 8 else 2 if rows <= 16 else 4


def gemv_wgmma_plan(k: int, tiles: int, nsrc: int, nb8: int) -> dict:
    """The wgmma GEMV's launch plan (``gw_plan``): the cluster size ``cs``
    (the largest power of two up to GW_MAX_CLUSTER, and no more than K's
    stages, whose tiles x cs blocks stay within GW_TARGET_BLOCKS; at least
    1), ``kr`` rows of K per rank (whole stages), the ring's ``stages``
    (as many as a block's share of its SM holds beside the partials and
    the rank's norm weights, at most the rank's stages and GW_MAX_STAGES,
    at least 1) and the dynamic shared bytes ``smem``."""
    units = -(-k // GW_KS)
    stage = nsrc * GW_W_BYTES + 8 * nb8 * 128
    cs = 1
    while cs < GW_MAX_CLUSTER and 2 * tiles * cs <= GW_TARGET_BLOCKS and (
            2 * cs <= units):
        cs *= 2
    nst = -(-units // cs)
    kr = nst * GW_KS
    per_sm = -(-(tiles * cs) // GW_SMS)
    fixed = nsrc * 8 * nb8 * GW_RPITCH * 4 + 2 * kr + GW_SLACK
    stages = max(1, min((GW_SM_SMEM // per_sm - GW_BLOCK_EXTRA - fixed)
                        // stage, GW_MAX_STAGES, nst))
    return dict(cs=cs, kr=kr, stages=stages, smem=fixed + stages * stage)


def gemv_route(kind: int, rows: int, k: int, tiles: int, nsrc: int) -> str:
    """The GEMV a bf16-activation launch of ``rows`` (<= 32) rows takes
    (``gw_route``): "wgmma" for bf16 weights (kind 0) where the plan fits
    a block's shared memory, else "mma" (every quantized kind)."""
    if kind == _KINDS[""] and gemv_wgmma_plan(
            k, tiles, nsrc, gemv_nb8(rows))["smem"] <= GW_SMEM_MAX:
        return "wgmma"
    return "mma"


def _single_kind(w, scales, int4: bool) -> int:
    if w.dtype != torch.int8:
        return _KINDS[""]
    if int4:
        return _KINDS["_q4g" if scales.ndim == 2 else "_q4"]
    return _KINDS["_q"]


def _single_product(xn, w, scales, int4: bool):
    """float32 x @ W times its scales: per-column scales on the whole
    sum, int4g group scales on each group's partial."""
    if int4:
        if scales.ndim == 2:
            return int4_grouped_partials(xn, w, scales)
        return int4_matmul_plain(xn, w, scales, out_dtype=torch.float32)
    if w.dtype == torch.int8:
        return quant_matmul_plain(xn, w, scales, out_dtype=torch.float32)
    return xn.float() @ w.float()


def _single_dense(w, scales, int4: bool):
    """The (K, N) float32 weight values of ``_single_product``, scaled."""
    if int4:
        if scales.ndim == 2:
            return dequantize_int4_grouped(w, scales)
        return unpack_int4(w) * scales.float()
    if w.dtype == torch.int8:
        return w.float() * scales.float()
    return w.float()


def gemv_single_reference(x, w, scales=None, *, int4: bool = False,
                          epilogue: str = "store", norm_w=None,
                          eps: float = 1e-6, res=None, w_up=None, s_up=None):
    """The float32 reference of one GEMV of K1 with the kernel's roundings
    up to its output: the normed row rounded to x's dtype, the float32
    product times its scales (``_single_product``), then the epilogue's
    inner roundings (residual: T(y); SwiGLU: T(gate), T(up), T(silu)).
    Returns (reference, slack): ``slack`` bounds, per element, how far a
    flip of one inner rounding (the kernel sums in another order) can move
    the output: a normed x element within 2e-6 of a rounding boundary (the
    kernel's RMSNorm factor sums in another order) by its one-ulp flip
    times |W|; one bf16 ulp (<= 2^-7 of the value) of each rounded
    intermediate, carried through the epilogue. An int4 SwiGLU without
    ``w_up`` takes gate and up from the low and high nibbles."""
    cdt = x.dtype
    ulp = 2.0 ** -7

    def product(w_, s_):
        """(x @ W, the prologue's flips through |W|)."""
        y = _single_product(xn, w_, s_, int4)
        if flip is None:
            return y, torch.zeros_like(y)
        return y, flip @ _single_dense(w_, s_, int4).abs()

    flip = None
    if norm_w is None:
        xn = x
    else:
        v = _rms(x, norm_w, eps)
        xn = v.to(cdt)
        flip = ((v * (1 + 2e-6)).to(cdt).float()
                - (v * (1 - 2e-6)).to(cdt).float()).abs()
    y, dy = product(w, scales)
    if epilogue == "store":
        return y, dy
    if epilogue == "residual":
        return res.float() + y.to(cdt).float(), ulp * y.abs() + dy
    if w_up is None:
        (gate, up), (dg, du) = y.chunk(2, -1), dy.chunk(2, -1)
    else:
        (gate, dg), (up, du) = (y, dy), product(w_up, s_up)
    g, u = gate.to(cdt).float(), up.to(cdt).float()
    act = (g * torch.sigmoid(g)).to(cdt).float()
    slack = (ulp * u.abs() * (1.1 * g.abs() + 2 * act.abs())
             + 1.1 * u.abs() * dg + act.abs() * du)
    return act * u, slack


def ssq_parts(y, tile_cols: int, int4: bool):
    """A residual GEMV's parts of each row's sum of squares: float32 sums
    of y (rows, N)'s squares over the outputs of each tile of tile_cols
    loaded columns (int4: loaded column j gives outputs j and j + N/2)."""
    sq = y.float() ** 2
    if int4:
        lo, hi = sq.chunk(2, -1)
        sq = torch.stack([lo, hi], -1).flatten(-2)
        tile_cols *= 2
    n = sq.shape[-1]
    sq = torch.nn.functional.pad(sq, (0, -n % tile_cols))
    return sq.reshape(sq.shape[0], -1, tile_cols).sum(-1)


def gemv_single_plain(x, w, scales=None, *, ssq: bool = False, **kw):
    """Plain version of ``gemv_single``: the reference rounded to x's
    dtype (and, residual with ``ssq``, its sums of squares' parts)."""
    out = gemv_single_reference(x, w, scales, **kw)[0].to(x.dtype)
    if ssq and kw.get("epilogue") == "residual":
        return out, ssq_parts(out, GEMV_TN, kw.get("int4", False))
    return out


# Per device: the single GEMV's split-K counters (zero on entry and left
# zero by the kernel)
_single_counters: dict = {}


@counted
def gemv_single(x, w, scales=None, *, int4: bool = False,
                epilogue: str = "store", norm_w=None, eps: float = 1e-6,
                res=None, w_up=None, s_up=None, ssq: bool = False,
                route: str = "rule"):
    """One GEMV of K1 alone, as the decode step launches it with bf16
    activations: x (rows, K) bf16 (RMSNorm by ``norm_w`` first, when
    given) @ w (K, N) bf16, int8 with (N,) scales, or int4 (``int4``: (K,
    N/2) packed, (N,) or int4g (G, N) scales), then the epilogue: "store"
    (rows, N); "residual" res + y; "swiglu" silu(gate) * up, gate from w
    and up from ``w_up``/``s_up`` (or, int4 without ``w_up``, the low and
    high nibbles of w). A "store" of bf16 weights may take ``w`` as a list
    of up to three (K, N_s) weights, column segments of one launch as the
    step's q|k|v, its output their columns side by side. ``ssq``, as in
    the decode step: a normed GEMV takes each row's sum of squares in
    parts (here the sums over 64-column tiles of x) instead of summing the
    row itself; a residual one returns (out, its parts, one per column
    tile: ``ssq_parts``). ``route``: "rule" (``gemv_route``, as the step),
    or "mma" / "wgmma" to run that GEMV (bf16 weights), for the card
    checks' comparisons. For the card checks; the decode step does not
    call it. CPU tensors run ``gemv_single_plain``; CUDA tensors launch
    the kernel (``gemv_single_launcher``)."""
    segments = list(w) if isinstance(w, (list, tuple)) else [w]
    if x.device.type == "cpu":
        return gemv_single_plain(x, torch.cat(segments, 1), scales,
                                 int4=int4, epilogue=epilogue, norm_w=norm_w,
                                 eps=eps, res=res, w_up=w_up, s_up=s_up,
                                 ssq=ssq)
    launch, out, ssq_out = gemv_single_launcher(
        x, w, scales, int4=int4, epilogue=epilogue, norm_w=norm_w, eps=eps,
        res=res, w_up=w_up, s_up=s_up, ssq=ssq, route=route)
    launch()
    return out if ssq_out is None else (out, ssq_out)


def gemv_single_launcher(x, w, scales=None, *, int4: bool = False,
                         epilogue: str = "store", norm_w=None,
                         eps: float = 1e-6, res=None, w_up=None, s_up=None,
                         ssq: bool = False, route: str = "rule"):
    """``gemv_single``'s launch on CUDA tensors with its operands made once:
    (launch, out, the residual's sums of squares or None); each
    ``launch()`` enqueues the GEMV on the current stream (so that a card
    check can capture a run of them in a CUDA graph) and counts it in
    ``gemv_single.launches`` (the wgmma GEMV's also in
    ``gemv_wgmma.launches``)."""
    segments = list(w) if isinstance(w, (list, tuple)) else [w]
    if len(segments) > 1 and (epilogue != "store" or scales is not None
                              or len(segments) > 3):
        raise ValueError("gemv_single: column segments are a store of up to "
                         "three bf16 weights")
    if x.device.type != "cuda" or x.dtype != torch.bfloat16 or x.ndim != 2:
        raise ValueError("gemv_single: x must be (rows, K) bf16 on CUDA")
    rows, k = x.shape
    w = segments[0]
    nls = [t.shape[1] for t in segments]
    nl = nls[0]
    kind = _single_kind(w, scales, int4)
    gsize = k // scales.shape[0] if kind == _KINDS["_q4g"] else 0
    nsrc = 2 if w_up is not None else 1
    n = sum(nls) * (2 if int4 else 1)
    n_out = n // 2 if epilogue == "swiglu" and w_up is None else n
    if epilogue == "swiglu" and w_up is None and kind == _KINDS["_q4"]:
        s_up = scales[nl:]  # the high nibbles' (up's) per-column scales
    out = torch.empty((rows, n_out), dtype=x.dtype, device=x.device)
    lib = _lib()
    ws = torch.empty(lib.gemv_single_ws_words(rows, k, sum(nls)),
                     dtype=torch.float32, device=x.device)
    if x.device not in _single_counters:
        _single_counters[x.device] = torch.zeros(
            1 << 16, dtype=torch.int32, device=x.device)
    counters = _single_counters[x.device]
    if sum(-(-c // GEMV_TN) for c in nls) > counters.numel():
        raise ValueError("gemv_single: too many columns")
    ssq_in = ssq_out = None
    ssq_stride = ssq_tiles = 0
    if ssq and norm_w is not None:
        ssq_in = ssq_parts(x, GEMV_TN, False)
        ssq_stride = ssq_tiles = ssq_in.shape[1]
    elif ssq and epilogue == "residual":
        ssq_stride = -(-nl // GEMV_TN)
        ssq_out = torch.empty((rows, ssq_stride), dtype=torch.float32,
                              device=x.device)
    tensors = [x, norm_w, w, w_up, scales, s_up, res, out, ws, counters,
               ssq_in, ssq_out] + (segments[1:] + [None, None])[:2]
    for t in tensors:
        if t is not None and (t.device != x.device or not t.is_contiguous()):
            raise ValueError("gemv_single: operands must be contiguous "
                             "tensors on one device")
    table = (ctypes.c_void_p * len(tensors))(
        *(None if t is None else t.data_ptr() for t in tensors))
    widths = (ctypes.c_int * 3)(*(nls + [0, 0])[:3])

    def launch():
        launches = (ctypes.c_int * 1)()
        rc = lib.gemv_single_bf16(
            table, kind, _EPILOGUES[epilogue], nsrc, rows, k,
            ctypes.addressof(widths), len(nls), nl, gsize, ssq_stride,
            ssq_tiles, eps, _ROUTES[route], ctypes.addressof(launches),
            _build.stream_of(x))
        _build.check(lib, rc, "gemv_single")
        gemv_single.launches += 1
        gemv_wgmma.launches += launches[0]

    launch.operands = tensors  # the table's pointers live as long as it
    return launch, out, ssq_out
