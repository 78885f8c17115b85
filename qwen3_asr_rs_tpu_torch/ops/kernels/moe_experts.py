"""K7: the routed experts of a mixture-of-experts layer, grouped by
expert: the router's choice (``route``) and the routes grouped by
expert (``align``) as Triton kernels (a reduction and a scan), the
experts' products (``moe_experts``) as CUDA C++ (``csrc/moe_experts.cu``,
built into ``build/`` with the port's other kernels by ``_build``).

Not a TPU kernel: the JAX package runs no routed decoder. A layer routes
each token to ``k`` of ``E`` experts (the published router of
DeepSeek-V3: float32 logits, sigmoid scores, a per-expert bias used only
for the choice, the chosen scores normalised and scaled), then every
expert computes ``down(silu(x W_gate) * (x W_up))`` for the tokens routed
to it, and each token's output is the weighted sum of its experts'.

What bounds it on the H100. In a decode step of 64 rows at top-6 of 64
experts, most experts get a few rows, so the step reads most experts'
weights, 17.3 MB each at Kimi-VL-A3B's widths: a GEMV-like product bound
by the bytes. A prefill's thousands of rows make each expert a matrix
product bound by the tensor cores. One design serves both: the routes
are grouped by expert on the device with no host read (so that a decode
step is captured in a CUDA graph), each expert's run padded to whole
blocks of ``BM`` rows, and a block of routes reads its expert's weight
tiles once for all of its rows, on the tensor-core tiles of
``csrc/gemv_mma.cuh``. At decode BM is 16, at prefill 64. The grid is
fixed by the shapes (the blocks' bound below); a block past the last
expert's run returns at once.

The kernels, in order. ``moe_route`` (one program per 16 tokens, the
float32 logits of one ``torch.mm`` in): sigmoid, the k largest of score
+ bias by k rounds of argmax, the weights normalised and scaled, each
live route counted into its expert by an atomic add, whose old value is
the route's rank in its expert's run (any order: a row's result does not
depend on where in its block it sits). ``moe_align``: the experts' padded
starts (a scan of 64 counts in every program), each live route written
to its start + rank, each block's expert found among the padded ends.
``moe_experts_gate_up``: a block's fused gate and up products, ``silu(
gate) * up`` rounded to the activations' dtype, in padded route order.
``moe_experts_down``: that times the expert's down weight, each route
scaled by its weight, float32 rows in route order, which the wrapper
sums over each token's k routes (a fixed order: no atomics, the same sum
on every run). A route whose expert is ``E`` (a row that is done, or a
prompt's padding) is computed by none of them.

Weights: ``gate_up_w`` (E, H, 2 I), gate columns first, and ``down_w``
(E, I, H), each expert's linears (in, out) as the port's other weights.
CPU tensors run the plain versions (the same arithmetic in torch ops,
ranks in route order); CUDA tensors launch the kernels or raise.
``moe_experts.launches`` counts the kernel launches (four per layer
call: route, align, gate-up, down).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..quant import matmul_f32
from . import _build, counted

_kernels: dict = {}


class Routes(NamedTuple):
    """One layer's routing: ``ids`` (T, k) int64 (E for a dead route),
    ``weights`` (T, k) float32, ``counts`` (E,) the live routes of each
    expert, ``rank`` (T, k) int32 each live route's place in its
    expert's run."""

    ids: torch.Tensor
    weights: torch.Tensor
    counts: torch.Tensor
    rank: torch.Tensor


def route_plain(x, router_w, bias, top_k: int, scale: float, norm: bool,
                live=None) -> Routes:
    """Plain PyTorch version of ``route``: ranks in route order."""
    n_experts = router_w.shape[1]
    scores = torch.sigmoid(matmul_f32(x, router_w))
    ids = torch.topk(scores + bias.float(), top_k, dim=-1).indices
    weights = scores.gather(1, ids)
    if norm:
        weights = weights / (weights.sum(-1, keepdim=True) + 1e-20)
    weights = weights * scale
    if live is not None:
        dead = ~live.reshape(-1, 1)
        ids = ids.masked_fill(dead, n_experts)
        weights = weights.masked_fill(dead, 0.0)
    onehot = F.one_hot(ids.reshape(-1), n_experts + 1)
    rank = (onehot.cumsum(0) - onehot).gather(1, ids.reshape(-1, 1))
    counts = onehot[:, :n_experts].sum(0)
    return Routes(ids, weights, counts,
                  rank.reshape(ids.shape).to(torch.int32))


def route(x, router_w, bias, top_k: int, scale: float, norm: bool,
          live=None) -> Routes:
    """The routing of the rows of ``x`` (T, H): float32 logits ``x @
    router_w`` (H, E) from x as it is (DeepSeek-V3's ``F.linear`` of the
    hidden state cast to float32), sigmoid scores, the k largest of score
    + ``bias`` chosen, their scores divided by their sum (+ 1e-20) when
    ``norm``, times ``scale``. Rows with ``live`` (T,) False get expert E
    (computed by nothing) and weight 0. CPU tensors: ``route_plain``."""
    if not x.is_cuda:
        return route_plain(x, router_w, bias, top_k, scale, norm, live)
    t, e = x.shape[0], router_w.shape[1]
    if e & (e - 1) or top_k > 8:
        raise ValueError(f"moe_route: E={e} (a power of two) and k={top_k} "
                         "(at most 8) are what the kernel takes")
    logits = matmul_f32(x, router_w).contiguous()
    ids = torch.empty((t, top_k), dtype=torch.int64, device=x.device)
    weights = torch.empty((t, top_k), dtype=torch.float32, device=x.device)
    rank = torch.empty((t, top_k), dtype=torch.int32, device=x.device)
    counts = torch.zeros(e, dtype=torch.int32, device=x.device)
    has_live = live is not None
    live_arg = live.reshape(-1) if has_live else counts
    k = _build_kernels()
    k["route"][(-(-t // 16),)](
        logits, bias, live_arg, ids, weights, rank, counts, t, float(scale),
        E=e, K=top_k, KP=8, NORM=bool(norm), HAS_LIVE=has_live, BT=16,
        num_warps=4)
    moe_experts.launches += 1
    return Routes(ids, weights, counts, rank)


def align_plain(routes: Routes, block_m: int):
    """Plain PyTorch version of ``align``."""
    flat = routes.ids.reshape(-1)
    n, e = flat.numel(), routes.counts.numel()
    counts = routes.counts.long()
    padded = (counts + block_m - 1) // block_m * block_m
    ends = padded.cumsum(0)
    n_blocks = -(-n // block_m) + e
    n_pad = n_blocks * block_m
    ec = flat.clamp(max=e - 1)
    dest = ends[ec] - padded[ec] + routes.rank.reshape(-1).long()
    dest = torch.where(flat < e, dest, n_pad)  # dead routes: a spare slot
    sorted_ids = torch.full((n_pad + 1,), n, dtype=torch.int32,
                            device=flat.device)
    sorted_ids.scatter_(0, dest, torch.arange(n, dtype=torch.int32,
                                              device=flat.device))
    starts = torch.arange(n_blocks, device=flat.device) * block_m
    block_expert = torch.searchsorted(ends, starts, right=True)
    return sorted_ids[:n_pad], block_expert.to(torch.int32)


def align(routes: Routes, block_m: int):
    """The routes grouped by expert, each expert's run padded to whole
    blocks of ``block_m``: (sorted (n_blocks * block_m,) int32, route
    index or the route count where a pad or a dead route lies;
    block_expert (n_blocks,) int32, E for blocks past the last expert's).
    ``n_blocks`` = ceil(N / block_m) + E, a bound from the shapes."""
    if not routes.ids.is_cuda:
        return align_plain(routes, block_m)
    n, e = routes.ids.numel(), routes.counts.numel()
    n_blocks = -(-n // block_m) + e
    dev = routes.ids.device
    sorted_ids = torch.full((n_blocks * block_m,), n, dtype=torch.int32,
                            device=dev)
    block_expert = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    chunk = 256
    grid = max(-(-n // chunk), -(-n_blocks // chunk))
    _build_kernels()["align"][(grid,)](
        routes.ids, routes.rank, routes.counts, sorted_ids, block_expert, n,
        n_blocks, E=e, BM=block_m, CH=chunk, num_warps=8)
    moe_experts.launches += 1
    return sorted_ids, block_expert


def moe_experts_plain(x, routes: Routes, gate_up_w, down_w):
    """Plain PyTorch version of ``moe_experts``: expert by expert, each
    product float32 (``matmul_f32``), ``silu(gate) * up`` rounded to x's
    dtype, each route's output times its weight in float32, summed over
    the token's routes in route order, rounded to x's dtype once."""
    t, k = routes.ids.shape
    inter = down_w.shape[1]
    flat = routes.ids.reshape(-1)
    out = torch.zeros((t * k, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    for j in range(gate_up_w.shape[0]):
        idx = (flat == j).nonzero()[:, 0]
        if idx.numel() == 0:
            continue
        gu = matmul_f32(x[idx // k], gate_up_w[j])
        act = (F.silu(gu[:, :inter]) * gu[:, inter:]).to(x.dtype)
        y = matmul_f32(act, down_w[j])
        out[idx] = y * routes.weights.reshape(-1)[idx, None].float()
    return out.view(t, k, -1).sum(1).to(x.dtype)


def _build_kernels():
    """The Triton kernels of the routing, built once (``triton`` is imported here: the
    CPU test suite imports this module without it)."""
    if _kernels:
        return _kernels
    import triton
    import triton.language as tl

    @triton.jit
    def moe_route(logits_ptr, bias_ptr, live_ptr, ids_ptr, w_ptr, rank_ptr,
                  counts_ptr, T, scale, E: tl.constexpr, K: tl.constexpr,
                  KP: tl.constexpr, NORM: tl.constexpr,
                  HAS_LIVE: tl.constexpr, BT: tl.constexpr):
        rows = tl.program_id(0) * BT + tl.arange(0, BT)
        ok = rows < T
        cols = tl.arange(0, E)
        kc = tl.arange(0, KP)
        lg = tl.load(logits_ptr + rows[:, None] * E + cols[None, :],
                     mask=ok[:, None], other=0.0)
        score = 1.0 / (1.0 + tl.exp(-lg))
        choice = score + tl.load(bias_ptr + cols).to(tl.float32)[None, :]
        live = ok
        if HAS_LIVE:
            live = ok & (tl.load(live_ptr + rows, mask=ok, other=0) != 0)
        ids = tl.zeros((BT, KP), dtype=tl.int32)
        ws = tl.zeros((BT, KP), dtype=tl.float32)
        for j in tl.static_range(K):
            best = tl.argmax(choice, axis=1)
            hit = cols[None, :] == best[:, None]
            wj = tl.sum(tl.where(hit, score, 0.0), axis=1)
            ids = tl.where(kc[None, :] == j, best[:, None], ids)
            ws = tl.where(kc[None, :] == j, wj[:, None], ws)
            choice = tl.where(hit, float("-inf"), choice)
        if NORM:
            ws = ws / (tl.sum(ws, axis=1)[:, None] + 1e-20)
        ws = ws * scale
        routed = live[:, None] & (kc[None, :] < K)
        ids = tl.where(live[:, None], ids, E)
        ws = tl.where(live[:, None], ws, 0.0)
        rank = tl.atomic_add(counts_ptr + ids, 1, mask=routed)
        out = rows[:, None] * K + kc[None, :]
        keep = ok[:, None] & (kc[None, :] < K)
        tl.store(ids_ptr + out, ids.to(tl.int64), mask=keep)
        tl.store(w_ptr + out, ws, mask=keep)
        tl.store(rank_ptr + out, tl.where(routed, rank, 0), mask=keep)

    @triton.jit
    def moe_align(ids_ptr, rank_ptr, counts_ptr, sorted_ptr, block_e_ptr,
                  N, n_blocks, E: tl.constexpr, BM: tl.constexpr,
                  CH: tl.constexpr):
        pid = tl.program_id(0)
        ec = tl.arange(0, E)
        padded = (tl.load(counts_ptr + ec) + BM - 1) // BM * BM
        ends = tl.cumsum(padded, 0)
        starts = ends - padded
        r = pid * CH + tl.arange(0, CH)
        e = tl.load(ids_ptr + r, mask=r < N, other=E).to(tl.int32)
        live = e < E
        rk = tl.load(rank_ptr + r, mask=live, other=0)
        st = tl.sum(tl.where(ec[None, :] == e[:, None], starts[None, :], 0),
                    axis=1)
        tl.store(sorted_ptr + st + rk, r, mask=live)
        b = pid * CH + tl.arange(0, CH)
        owner = tl.sum((ends[None, :] <= (b * BM)[:, None]).to(tl.int32),
                       axis=1)
        tl.store(block_e_ptr + b, owner, mask=b < n_blocks)

    _kernels.update(route=moe_route, align=moe_align)
    return _kernels


def _lib():
    lib = _build.load("moe_experts")
    if not getattr(lib, "_bound", False):
        _build.bind(lib, "moe_experts_gate_up", 5, (ctypes.c_int,) * 7)
        _build.bind(lib, "moe_experts_down", 6, (ctypes.c_int,) * 6)
        lib._bound = True
    return lib


def block_rows(n_routes: int, n_experts: int) -> int:
    """Rows per block by the route count alone: a decode step's few rows
    per expert in blocks of 16 (one read of an expert's weights for all
    its rows), a prefill's in blocks of 64."""
    return 16 if n_routes <= 16 * n_experts else 64


@counted
def moe_experts(x, routes: Routes, gate_up_w, down_w):
    """The routed experts' output (T, H) in x's dtype for the rows of
    ``x`` (T, H) and their ``routes`` (``route``), ``gate_up_w`` (E, H,
    2 I) and ``down_w`` (E, I, H). CPU tensors run the plain version;
    CUDA tensors launch K7 (bf16 x and weights, H and I multiples of 64)
    or raise."""
    if not x.is_cuda:
        return moe_experts_plain(x, routes, gate_up_w, down_w)
    t, h = x.shape
    n_experts = gate_up_w.shape[0]
    top_k = routes.ids.shape[1]
    inter = down_w.shape[1]
    if (x.dtype != torch.bfloat16 or gate_up_w.dtype != torch.bfloat16
            or down_w.dtype != torch.bfloat16):
        raise ValueError("moe_experts: K7 takes bf16 activations and weights")
    if h % 64 or inter % 64 or gate_up_w.shape[1:] != (h, 2 * inter):
        raise ValueError(
            f"moe_experts: widths H={h}, I={inter} (multiples of 64) and "
            f"gate_up_w {tuple(gate_up_w.shape)}, down_w "
            f"{tuple(down_w.shape)} do not fit K7")
    for w in (x, gate_up_w, down_w):
        if not w.is_contiguous():
            raise ValueError("moe_experts: K7 takes contiguous tensors")
    n = t * top_k
    bm = block_rows(n, n_experts)
    sorted_ids, block_expert = align(routes, bm)
    n_blocks = block_expert.numel()
    act = torch.empty((n_blocks * bm, inter), dtype=x.dtype, device=x.device)
    out = torch.zeros((n, h), dtype=torch.float32, device=x.device)
    lib, p, stream = _lib(), _build.ptr, _build.stream_of(x)
    rc = lib.moe_experts_gate_up(
        p(x), p(gate_up_w), p(sorted_ids), p(block_expert), p(act), n,
        n_experts, n_blocks, h, inter, top_k, bm, stream)
    _build.check(lib, rc, "moe_experts_gate_up")
    rc = lib.moe_experts_down(
        p(act), p(down_w), p(sorted_ids), p(block_expert),
        p(routes.weights), p(out), n, n_experts, n_blocks, h, inter, bm,
        stream)
    _build.check(lib, rc, "moe_experts_down")
    moe_experts.launches += 2
    return out.view(t, top_k, h).sum(1, dtype=torch.float32).to(x.dtype)
