"""K5: weight-only int8 matmul, ``(x @ w_q) * scales``.

Replaces the Pallas kernel
``qwen3_asr_rs_tpu/ops/pallas/quant_matmul.py::quant_matmul``, and is what
the port's int8 linears (``models/text_decoder.py::_linear``, prefill and
the per-layer decode path) and int8 lm_head (``TextDecoder.logits``) run
on; the JAX decoder computes the same contract through XLA. x (R, K),
w_q (K, N) int8, scales (N,) float32. Products in float32 from x's values
(bf16 x: exact), float32 accumulation, the per-column scale applied to
the whole sum, one rounding to ``out_dtype`` (default x.dtype).

The bf16 instance is the Pallas kernel's contract (it casts x to bf16);
the float32 instance keeps x in float32, which is the contract of the
JAX decoder's ``_linear`` and int8 lm_head in a float32 model.

Kernel: ``csrc/quant_matmul.cu`` (see the note there), three routes from
the shapes (``launch_plan``): bf16 x above 32 rows (prefill) on 128 x 128
``wgmma`` tiles fed by TMA from a producer warp, the int8 weight converted
to bf16 in shared memory, a K split where the tiles cannot fill the card;
bf16 x up to 32 rows (the lm_head) on the tensor-core GEMV blocks of
``csrc/gemv_mma.cuh``, one read of the weight; float32 x on the CUDA
cores. Split partials are added in split order by a second kernel, which
applies the scales.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build, counted

# The routes of csrc/quant_matmul.cu (QmRoute)
ROUTES = {"cores": 0, "gemv": 1, "wgmma": 2}
# qm_plan's constants
GEMV_ROWS = 32          # bf16 rows the GEMV blocks take
TILE = 128              # a wgmma block's tile: 128 columns by 128 rows
TILE_K = 64             # K rows per stage
TARGET_BLOCKS = 264     # two blocks per SM of the H100 SXM
MIN_STAGES = 4          # K stages a split keeps at least
GEMV_TN = 64            # columns per GEMV block
QMV_TN = 256            # columns per CUDA-core GEMV block
_PLAN_KEYS = ("route", "splits", "kb", "grid_x", "grid_y", "ws_words",
              "smem")
# A wgmma block's shared memory: 3 stages of x (16 KB) and int8 weights
# (8 KB), each warpgroup's two bf16 A tiles (8 KB each), two barriers per
# stage and the slack that aligns the swizzled tiles
WGMMA_SMEM = 3 * (16384 + 8192) + 4 * 8192 + 3 * 16 + 1024


def quant_matmul_plain(x, w_q, scales, *, out_dtype=None):
    """Plain PyTorch version: float32 product of x's values and the int8
    weights, times the scales, rounded once to ``out_dtype``."""
    y = x.float() @ w_q.float()
    return (y * scales.float()).to(out_dtype or x.dtype)


def launch_plan(r: int, k: int, n: int, f32: bool) -> dict:
    """The launch plan of an (r, k) @ (k, n) product, as ``qm_plan``
    makes it: the route (float32 x: "cores"; bf16 x: "gemv" up to 32
    rows, else "wgmma"), the K split (splits of kb rows), the grid (wgmma:
    128-column tiles, 128-row tiles; gemv: 64-column tiles, splits), the
    split-K workspace in floats and the dynamic shared memory in bytes.
    wgmma splits K where its tiles cannot fill a round of one block per
    SM: up to one round of two, at least 4 stages per split."""
    from .decode_layer import gemv_split_rows

    route = "cores" if f32 else "gemv" if r <= GEMV_ROWS else "wgmma"
    splits, kb, gx, gy, smem = 1, k, 0, 0, 0
    if route == "cores":
        gx = -(-n // (QMV_TN if r <= 8 else TILE))
        gy = 1 if r <= 8 else -(-r // TILE)
    elif route == "gemv":
        nb8 = 1 if r <= 8 else 2 if r <= 16 else 4
        gx = -(-n // GEMV_TN)
        kb = gemv_split_rows(k, gx, r, 1, 1, TILE_K, nb8)
        splits = gy = -(-k // kb)
        # a 4-stage ring of 64 rows x 80 bytes, then the staged x rows
        smem = 4 * 64 * 80 + 16 * nb8 * (kb + 8)
    elif route == "wgmma":
        gx, gy = -(-n // TILE), -(-r // TILE)
        tiles, nst = gx * gy, -(-k // TILE_K)
        if tiles < TARGET_BLOCKS // 2:
            splits = max(1, min(TARGET_BLOCKS // tiles, nst // MIN_STAGES))
        kb = -(-nst // splits) * TILE_K
        splits = -(-k // kb)
        smem = WGMMA_SMEM
    return {"route": route, "splits": splits, "kb": kb, "grid_x": gx,
            "grid_y": gy, "ws_words": r * n * splits if splits > 1 else 0,
            "smem": smem}


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_bound", False):
        for fn in ("quant_matmul_bf16", "quant_matmul_bf16_f32",
                   "quant_matmul_f32"):
            _build.bind(lib, fn, 5, (ctypes.c_int,) * 3)
        lib.quant_matmul_plan.argtypes = (
            [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_longlong)])
        lib.quant_matmul_plan.restype = None
        lib._bound = True
    return lib


def kernel_plan(r: int, k: int, n: int, f32: bool) -> dict:
    """``launch_plan`` as the C library computes it (on the card)."""
    plan = (ctypes.c_longlong * len(_PLAN_KEYS))()
    _lib().quant_matmul_plan(r, k, n, int(f32), plan)
    out = dict(zip(_PLAN_KEYS, plan))
    out["route"] = {v: name for name, v in ROUTES.items()}[out["route"]]
    return out


# Per shape: the split-K workspace floats of its launch plan
_ws_words: dict = {}
# Per (device, stream): one split-K workspace, grown to the largest plan
# seen; calls ordered on one stream share it. A grown-out workspace is
# kept: a CUDA graph captured with it goes on writing there.
_workspaces: dict = {}
_superseded: list = []


def _workspace(device, stream: int, words: int):
    ws = _workspaces.get((device, stream))
    if ws is None or ws.numel() < words:
        if ws is not None:
            _superseded.append(ws)
        ws = torch.empty(max(words, 1), dtype=torch.float32, device=device)
        _workspaces[(device, stream)] = ws
    return ws


@counted
def quant_matmul(x, w_q, scales, *, out_dtype=None):
    """(R, K) x @ (K, N) int8 ``w_q`` x ``scales`` -> (R, N) ``out_dtype``.

    CPU tensors run ``quant_matmul_plain``; CUDA tensors launch the kernel
    (``quant_matmul.launches`` counts those launches). The kernel takes
    bf16 x with a bf16 or float32 output and float32 x with a float32
    output, N a multiple of 8, contiguous operands; bf16 x also K a
    multiple of 8 and 16-byte aligned rows.
    """
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return quant_matmul_plain(x, w_q, scales, out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"quant_matmul: device {x.device} not supported")
    r, k = x.shape
    n = w_q.shape[-1]
    names = {
        (torch.bfloat16, torch.bfloat16): "quant_matmul_bf16",
        (torch.bfloat16, torch.float32): "quant_matmul_bf16_f32",
        (torch.float32, torch.float32): "quant_matmul_f32",
    }
    if (x.dtype, out_dtype) not in names:
        raise ValueError(
            f"quant_matmul: x {x.dtype} -> {out_dtype} not supported")
    if w_q.shape != (k, n) or w_q.dtype != torch.int8 or n % 8:
        raise ValueError(
            f"quant_matmul: w_q must be (K={k}, N) int8 with N % 8 == 0, "
            f"got {tuple(w_q.shape)} {w_q.dtype}")
    if scales.shape != (n,) or scales.dtype != torch.float32:
        raise ValueError("quant_matmul: scales must be (N,) float32")
    for t in (x, w_q, scales):
        if t.device != x.device or not t.is_contiguous():
            raise ValueError("quant_matmul: operands must be contiguous "
                             "tensors on one device")
    if x.dtype == torch.bfloat16 and (k % 8 or x.data_ptr() % 16
                                      or w_q.data_ptr() % 8):
        raise ValueError(
            f"quant_matmul: bf16 x needs K % 8 == 0 (got {k}), x 16-byte "
            "and w_q 8-byte aligned")
    f32 = x.dtype == torch.float32
    stream = _build.stream_of(x)
    lib = _lib()
    shape = (r, k, n, f32)
    if shape not in _ws_words:
        _ws_words[shape] = kernel_plan(*shape)["ws_words"]
    ws = _workspace(x.device, stream.value, _ws_words[shape])
    out = torch.empty((r, n), dtype=out_dtype, device=x.device)
    p = _build.ptr
    rc = getattr(lib, names[(x.dtype, out_dtype)])(
        p(x), p(w_q), p(scales), p(out), p(ws), r, k, n, stream)
    _build.check(lib, rc, "quant_matmul")
    quant_matmul.launches += 1
    return out
