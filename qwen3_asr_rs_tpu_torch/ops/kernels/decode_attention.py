"""K2 and K6: decode attention over the stacked KV slab.

K2, ``decode_attention_dma``, replaces the Pallas kernel
``qwen3_asr_rs_tpu/ops/pallas/decode_attention.py::decode_attention_dma``
in its bf16/f32 and int8-KV modes. One query token per example attends,
per layer ``layer`` of the ``(L, B, Hkv, S, D)`` slab, to the live slots
``[start_b, end_b)`` plus its own fresh key/value as an explicit extra
key, with GQA (query head h reads kv head h // G). An int8 slab comes
with float32 scales ``(L, B, Hkv, S)`` per slot, folded as in the Pallas
kernel: K scales multiply the raw scores before the live-range mask
(a dead slot's scale can be 0), V scales multiply the probabilities of
the PV sum, and the softmax denominator takes the unscaled ones. The
self K/V stay in q's dtype.

K6, ``decode_attention_slab`` and its single-layer wrapper
``decode_attention``, replaces the Pallas kernel of the same names
(``decode_attention.py:157`` and ``:233``): the same function, bf16/f32
slabs only, any slab length. The Pallas version walks a grid over every
slot block and clamps the block index outside the live range so that
dead blocks cost no copy; K2's Pallas version copies only live blocks by
hand. On the H100 both schedules are one design, so K6 launches K2's
device code. The JAX package calls K6 from its tests and scripts only;
the port's main path runs K2 (inside K1, and in the per-layer decode
path).

Kernel: ``csrc/decode_attention.cuh`` (see the note there), one launch
per call. What bounds it on the H100 is the live K/V bytes: 2 * live *
Hkv * D * 2 bytes per layer and example in bf16 (20 MB at 4992 live
slots, 6 us at 3.35 TB/s), half that in int8 plus 4 bytes of scales per
slot and head. The slot axis is cut into chunks by the split rule
(``split_chunk``, the Python mirror of the C ``attn_chunk``); each
(chunk, kv head, example) block streams the live part of its chunk
through a cp.async ring in shared memory and publishes a (max, sum,
acc) partial per query head, and the last block of each (kv head,
example) to arrive folds the partials and the self K/V in the same
launch. The same device code is the attention stage of the decode step
(K1, ``decode_layer.py``): K1's C entry counts each of its launches, and
K1's wrapper adds that count to ``decode_attention_dma.launches``. Each
of the three entries has its own plain version and its own launch
counter.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, counted

_SUPPORTED_D = (64, 128)
_MAX_GROUPS = 8
# the split rule's least chunk (ATTN_MIN_CHUNK in csrc/decode_attention.cuh)
MIN_CHUNK = 64

# The Python mirror of the split rule, for tests. ``target_blocks`` is the
# kernel's block target, ATTN_TARGET_BLOCKS, which only the C library
# holds (``decode_attention_target_blocks()``); the wrappers size their
# workspace through the library and never call these.


def split_chunk(b: int, hkv: int, s: int, target_blocks: int) -> int:
    """Slots per split for b examples and hkv kv heads over an s-slot
    slab: as many splits as keep splits x hkv x b within target_blocks
    blocks (at least one), in chunks of a multiple of MIN_CHUNK slots
    (``attn_chunk``)."""
    splits = max(target_blocks // (b * hkv), 1)
    chunk = -(-s // splits)
    return max(-(-chunk // MIN_CHUNK) * MIN_CHUNK, MIN_CHUNK)


def num_splits(b: int, hkv: int, s: int, target_blocks: int) -> int:
    """Splits of the slot axis (the kernel's grid.x)."""
    return -(-s // split_chunk(b, hkv, s, target_blocks))


def workspace_words(b: int, hq: int, hkv: int, s: int, d: int,
                    target_blocks: int) -> int:
    """4-byte words of the launch's workspace: acc[d] and (max, sum) per
    (example, query head, split), then one int32 counter per (example, kv
    head) (``attn_workspace_words``)."""
    n = b * hq * num_splits(b, hkv, s, target_blocks)
    return n * d + 2 * n + b * hkv


def _attention_plain(q, k_slabs, v_slabs, k_self, v_self, layer: int, start,
                     end, k_scales=None, v_scales=None, scale=None):
    """The plain arithmetic of K2 and K6 (``decode_attention_dma_plain``)."""
    b, hq, d = q.shape
    _, _, hkv, s_max, _ = k_slabs.shape
    g = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf = q.float().reshape(b, hkv, g, d)
    k = k_slabs[layer].float()  # (B, Hkv, S, D)
    v = v_slabs[layer].float()
    s = torch.einsum("bhgd,bhsd->bhgs", qf, k) * scale
    if k_scales is not None:  # before the mask: a dead slot's scale may be 0
        s = s * k_scales[layer][:, :, None, :]
    slot = torch.arange(s_max, device=q.device)[None, :]
    live = slot < end[:, None]
    if start is not None:
        live = live & (slot >= start[:, None])
    s = torch.where(live[:, None, None, :], s, -torch.inf)
    s_self = (qf * k_self.float()[:, :, None, :]).sum(-1) * scale  # (B,Hkv,G)
    m = torch.maximum(s.amax(-1), s_self)
    p = torch.exp(s - m[..., None])
    p_self = torch.exp(s_self - m)
    denom = p.sum(-1) + p_self
    if v_scales is not None:
        p = p * v_scales[layer][:, :, None, :]
    acc = torch.einsum("bhgs,bhsd->bhgd", p, v)
    acc = acc + p_self[..., None] * v_self.float()[:, :, None, :]
    out = acc / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(b, hq, d).to(q.dtype)


def decode_attention_dma_plain(q, k_slabs, v_slabs, k_self, v_self,
                               layer: int, start, end, *, k_scales=None,
                               v_scales=None, scale: float | None = None):
    """Plain PyTorch version of K2: float32 scores and softmax over the
    live slots plus the self key, unnormalized accumulation, one division.

    q (B, Hq, D); k/v_slabs (L, B, Hkv, S, D) (int8 with ``k_scales`` /
    ``v_scales`` (L, B, Hkv, S) float32); k/v_self (B, Hkv, D);
    start (B,) int or None; end (B,) int. Returns (B, Hq, D) in q.dtype.
    """
    return _attention_plain(q, k_slabs, v_slabs, k_self, v_self, layer,
                            start, end, k_scales, v_scales, scale)


def decode_attention_slab_plain(q, k_slabs, v_slabs, k_self, v_self,
                                layer: int, start, end, *,
                                scale: float | None = None):
    """Plain PyTorch version of K6 (bf16/f32 slabs): the same arithmetic
    as ``decode_attention_dma_plain``."""
    return _attention_plain(q, k_slabs, v_slabs, k_self, v_self, layer,
                            start, end, scale=scale)


def decode_attention_plain(q, k_slab, v_slab, k_self, v_self, start, end, *,
                           scale: float | None = None):
    """Plain PyTorch version of K6's single-layer wrapper: k/v_slab
    (B, Hkv, S, D)."""
    return _attention_plain(q, k_slab[None], v_slab[None], k_self, v_self,
                            0, start, end, scale=scale)


def _as_index(x, b: int, device) -> torch.Tensor:
    """(B,) int32 device tensor from an int, a 0-d or a (B,) tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.int32).expand(b).contiguous()
    return torch.full((b,), int(x), dtype=torch.int32, device=device)


def check_slabs(k_slabs, v_slabs, b: int, hq: int, d: int, dtype, device,
                k_scales=None, v_scales=None) -> None:
    """Raise ValueError unless the slabs are contiguous (L, b, Hkv, S, d)
    tensors on ``device`` that the CUDA kernel takes for ``hq`` query
    heads: of ``dtype``, or int8 with contiguous (L, b, Hkv, S) float32
    ``k_scales`` and ``v_scales``."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"decode_attention: dtype {dtype} not supported")
    if k_slabs.ndim != 5 or k_slabs.shape != v_slabs.shape:
        raise ValueError("decode_attention: slabs must be (L, B, Hkv, S, D)")
    _, sb, hkv, _, sd = k_slabs.shape
    if (sb, sd) != (b, d):
        raise ValueError("decode_attention: inconsistent shapes")
    if d not in _SUPPORTED_D or hq % hkv or hq // hkv > _MAX_GROUPS:
        raise ValueError(
            f"decode_attention: kernel takes head_dim in {_SUPPORTED_D} and "
            f"at most {_MAX_GROUPS} query heads per kv head, got D={d}, "
            f"Hq={hq}, Hkv={hkv}"
        )
    if (k_scales is None) != (v_scales is None):
        raise ValueError("decode_attention: pass both slab scales or neither")
    slab_dtype = dtype if k_scales is None else torch.int8
    for t in (k_slabs, v_slabs):
        if t.dtype != slab_dtype or t.device != device or not t.is_contiguous():
            raise ValueError(
                f"decode_attention: slabs must be contiguous {slab_dtype} "
                f"on {device}"
            )
    for t in () if k_scales is None else (k_scales, v_scales):
        if (t.shape != k_slabs.shape[:4] or t.dtype != torch.float32
                or t.device != device or not t.is_contiguous()):
            raise ValueError(
                "decode_attention: slab scales must be contiguous "
                f"{tuple(k_slabs.shape[:4])} float32 on {device}"
            )


def check_decode_attention_shapes(q, k_slabs, v_slabs, k_self, v_self,
                                  k_scales=None, v_scales=None):
    """Raise ValueError on anything the CUDA kernel does not take."""
    b, hq, d = q.shape
    check_slabs(k_slabs, v_slabs, b, hq, d, q.dtype, q.device, k_scales,
                v_scales)
    hkv = k_slabs.shape[2]
    if k_self.shape != (b, hkv, d) or v_self.shape != (b, hkv, d):
        raise ValueError("decode_attention: inconsistent shapes")
    for t in (q, k_self, v_self):
        if t.dtype != q.dtype or t.device != q.device or not t.is_contiguous():
            raise ValueError(
                "decode_attention: operands must share dtype and device "
                "and be contiguous"
            )


def _lib():
    lib = _build.load("decode_attention")
    if not getattr(lib, "_bound", False):
        for fn in ("decode_attention_bf16", "decode_attention_f32"):
            _build.bind(lib, fn, 11, (ctypes.c_int,) * 8 + (ctypes.c_float,))
        lib.decode_attention_workspace.argtypes = [ctypes.c_int] * 5
        lib.decode_attention_workspace.restype = ctypes.c_longlong
        lib.decode_attention_chunk.argtypes = [ctypes.c_int] * 3
        lib.decode_attention_chunk.restype = ctypes.c_int
        lib.decode_attention_target_blocks.argtypes = []
        lib.decode_attention_target_blocks.restype = ctypes.c_int
        lib._bound = True
    return lib


# Per (device, stream, shape): the launch's workspace, its counters zero
# on entry (the kernel leaves them zero), reused by every launch that is
# ordered on the same stream.
_workspaces: dict = {}


def _index_arg(x, b: int, device):
    """(tensor, value) of a start/end argument: a (B,) int32 device
    tensor (kept alive by the caller until the launch), or None and an int
    for every row."""
    if isinstance(x, torch.Tensor):
        return _as_index(x, b, device), 0
    return None, int(x)


def _launch(what, q, k_slabs, v_slabs, k_self, v_self, layer: int, start,
            end, k_scales, v_scales, scale):
    """Check the operands and launch K2's device code on CUDA tensors."""
    b = q.shape[0]
    if q.device.type != "cuda":
        raise ValueError(f"{what}: device {q.device} not supported")
    check_decode_attention_shapes(q, k_slabs, v_slabs, k_self, v_self,
                                  k_scales, v_scales)
    _, hq, d = q.shape
    nl, _, hkv, s_max, _ = k_slabs.shape
    if not 0 <= layer < nl:
        raise ValueError(f"{what}: layer {layer} out of range")
    _build.check_not_frozen(f"{what}: end", end)
    start_t, start_v = _index_arg(0 if start is None else start, b, q.device)
    end_t, end_v = _index_arg(end, b, q.device)
    lib = _lib()
    stream = _build.stream_of(q)
    key = (q.device, stream.value, b, hq, hkv, s_max, d)
    if key not in _workspaces:
        _workspaces[key] = torch.zeros(
            lib.decode_attention_workspace(b, hq, hkv, s_max, d),
            dtype=torch.float32, device=q.device)
    ws = _workspaces[key]
    out = torch.empty_like(q)
    fn = (lib.decode_attention_bf16 if q.dtype == torch.bfloat16
          else lib.decode_attention_f32)
    p = _build.ptr
    scales = (None, None) if k_scales is None else (p(k_scales), p(v_scales))
    rc = fn(p(q), p(k_slabs), p(v_slabs), *scales, p(k_self), p(v_self),
            None if start_t is None else p(start_t),
            None if end_t is None else p(end_t), p(out), p(ws), layer, b, hq,
            hkv, s_max, d,
            start_v, end_v, d ** -0.5 if scale is None else scale, stream)
    if rc != 0:
        del _workspaces[key]  # a failed launch may leave a counter nonzero
    _build.check(lib, rc, what)
    return out


def _plain_index(start, end, b, device):
    return (None if start is None else _as_index(start, b, device),
            _as_index(end, b, device))


@counted
def decode_attention_dma(q, k_slabs, v_slabs, k_self, v_self, layer: int,
                         start, end, *, k_scales=None, v_scales=None,
                         scale: float | None = None):
    """K2 (see module docstring). ``start`` (None, int or (B,) tensor) and
    ``end`` (int or (B,) tensor; a tensor while a CUDA graph is captured)
    bound the live slots of layer ``layer``;
    ``k_scales``/``v_scales`` go with int8 slabs.

    CPU tensors run ``decode_attention_dma_plain``; CUDA tensors launch
    the kernel (``decode_attention_dma.launches`` counts those launches).
    """
    if q.device.type == "cpu":
        return decode_attention_dma_plain(
            q, k_slabs, v_slabs, k_self, v_self, layer,
            *_plain_index(start, end, q.shape[0], q.device),
            k_scales=k_scales, v_scales=v_scales, scale=scale)
    out = _launch("decode_attention_dma", q, k_slabs, v_slabs, k_self,
                  v_self, layer, start, end, k_scales, v_scales, scale)
    decode_attention_dma.launches += 1
    return out


def _check_float_slabs(what, k_slabs):
    if k_slabs.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{what}: takes bf16/f32 slabs, got {k_slabs.dtype}")


@counted
def decode_attention_slab(q, k_slabs, v_slabs, k_self, v_self, layer: int,
                          start, end, *, scale: float | None = None,
                          block_s: int = 512):
    """K6: decode attention over layer ``layer`` of bf16/f32 slabs
    (L, B, Hkv, S, D), any S. ``block_s`` is the Pallas kernel's slot
    block and is accepted only for its signature: the CUDA kernel's
    chunking does not depend on it.

    CPU tensors run ``decode_attention_slab_plain``; CUDA tensors launch
    K2's device code (``decode_attention_slab.launches`` counts them).
    """
    del block_s
    _check_float_slabs("decode_attention_slab", k_slabs)
    if q.device.type == "cpu":
        return decode_attention_slab_plain(
            q, k_slabs, v_slabs, k_self, v_self, layer,
            *_plain_index(start, end, q.shape[0], q.device), scale=scale)
    out = _launch("decode_attention_slab", q, k_slabs, v_slabs, k_self,
                  v_self, layer, start, end, None, None, scale)
    decode_attention_slab.launches += 1
    return out


@counted
def decode_attention(q, k_slab, v_slab, k_self, v_self, start, end, *,
                     scale: float | None = None, block_s: int = 512):
    """K6's single-layer wrapper: k/v_slab (B, Hkv, S, D) bf16/f32.

    CPU tensors run ``decode_attention_plain``; CUDA tensors launch K2's
    device code (``decode_attention.launches`` counts them)."""
    del block_s
    _check_float_slabs("decode_attention", k_slab)
    if q.device.type == "cpu":
        return decode_attention_plain(
            q, k_slab, v_slab, k_self, v_self,
            *_plain_index(start, end, q.shape[0], q.device), scale=scale)
    out = _launch("decode_attention", q, k_slab[None], v_slab[None], k_self,
                  v_self, 0, start, end, None, None, scale)
    decode_attention.launches += 1
    return out
