"""The sampled token: ``jax.random.categorical`` on float32 logits from
JAX's threefry stream, as one CUDA kernel.

Not a TPU kernel: the JAX package's ``sample_token`` leaves the draw to
XLA (``jax.random.categorical``). ``gumbel_argmax(x, key, row_offset)``
returns, per row of the (B, V) float32 logits ``x``, ``argmax(x +
gumbel(key, x.shape))`` with ties to the lowest index, the bits of row r
those of row ``row_offset + r`` of a wider array (or of row
``row_offset[r]``, a (B,) int64 tensor); ``key`` is a key tensor or a
``ops/prng.py::KeyChain``, whose key the kernel derives itself.
``threefry_noise`` returns the draw's bits, uniforms or Gumbel noise
(the card's checks, and speculative sampling's acceptance uniforms).

Kernel: ``csrc/gumbel_argmax.cu`` (see the note there: one pass over the
logits, threefry in registers, a 64-bit atomicMax per row, the last
block writes the tokens and moves a split key chain). CPU tensors run the
plain versions (``ops/prng.py``); CUDA tensors launch the kernel or
raise. ``gumbel_argmax.launches`` and ``threefry_noise.launches`` count
the launches.
"""

from __future__ import annotations

import ctypes

import torch

from ..prng import (
    FLOAT32_TINY,
    MAX_CHAIN,
    KeyChain,
    as_chain,
    categorical,
    gumbel_from_bits,
    random_bits,
    row_offsets,
    uniform_from_bits,
)
from . import _build, counted

NOISE_MODES = ("bits", "uniform", "uniform_tiny", "gumbel")

# Per (device, stream): the per-row best keys and the ticket (zero on
# entry, left zero by the kernel). A scratch that grows keeps the old one
# alive: a captured graph may still hold its address.
_scratch: dict = {}
_retired: list = []


def _lib():
    lib = _build.load("gumbel_argmax")
    if not getattr(lib, "_bound", False):
        ll, i = ctypes.c_longlong, ctypes.c_int
        _build.bind(lib, "gumbel_argmax", 10,
                    (ll, i, i, ll, ll, ll, ll, i, i, ll))
        _build.bind(lib, "threefry_noise", 7,
                    (i, i, ll, ll, ll, ll, i, ll, i))
        lib._bound = True
    return lib


def gumbel_argmax_plain(x, key, row_offset=0):
    """Plain PyTorch version: ``prng.categorical`` with the chain's key,
    then the chain's split."""
    chain = as_chain(key)
    out = categorical(chain.resolve(), x, row_offset)
    chain.advance()
    return out


def threefry_noise_plain(key, shape, mode: str = "gumbel", row_offset=0):
    """Plain PyTorch version of ``threefry_noise``."""
    b, v = shape
    bits = random_bits(as_chain(key).resolve(), (b, v),
                       row_offsets(b, v, row_offset))
    if mode == "bits":
        return bits
    if mode == "uniform":
        return uniform_from_bits(bits)
    if mode == "uniform_tiny":
        return uniform_from_bits(bits, FLOAT32_TINY, 1.0)
    return gumbel_from_bits(bits)


def _chain_args(chain: KeyChain, device):
    """(key, 4 counter pointers, 4 constants, n) of a chain; the key and
    counters must be int64 on ``device``."""
    key = chain.base
    if key.shape != (2,) or key.dtype != torch.int64 or key.device != device:
        raise ValueError(
            f"gumbel_argmax: the key must be a (2,) int64 tensor on {device}, "
            f"got {tuple(key.shape)} {key.dtype} on {key.device}")
    ptrs, adds = [], []
    for d in chain.data:
        t, add = (d if isinstance(d, tuple)
                  else (d, 0) if isinstance(d, torch.Tensor) else (None, d))
        if t is not None and (t.numel() != 1 or t.dtype != torch.int64
                              or t.device != device):
            raise ValueError(
                "gumbel_argmax: a fold_in counter must be a one-element "
                f"int64 tensor on {device}")
        ptrs.append(None if t is None else _build.ptr(t))
        adds.append(int(add))
    pad = MAX_CHAIN - len(ptrs)
    return ([_build.ptr(key)] + ptrs + [None] * pad, adds + [0] * pad,
            len(chain.data))


def _rows_arg(row_offset, b: int, device):
    """(rows pointer or None, int offset)."""
    if isinstance(row_offset, torch.Tensor):
        if (row_offset.shape != (b,) or row_offset.dtype != torch.int64
                or row_offset.device != device
                or not row_offset.is_contiguous()):
            raise ValueError(
                f"gumbel_argmax: row indices must be a contiguous ({b},) "
                f"int64 tensor on {device}")
        return _build.ptr(row_offset), 0
    return None, int(row_offset)


@counted
def gumbel_argmax(x, key, row_offset=0):
    """(B, V) float32 -> (B,) int64 sampled ids (see module docstring).
    With ``key`` a ``KeyChain`` whose ``then_split`` is set, its base key
    moves to ``fold_in(base, 0)`` after the draw."""
    if x.device.type == "cpu":
        return gumbel_argmax_plain(x, key, row_offset)
    if x.device.type != "cuda":
        raise ValueError(f"gumbel_argmax: device {x.device} not supported")
    if x.dtype != torch.float32 or x.ndim != 2 or x.stride(1) != 1:
        raise ValueError(
            "gumbel_argmax: logits must be (B, V) float32 with unit column "
            f"stride, got {tuple(x.shape)} {x.dtype} strides {x.stride()}")
    b, v = x.shape
    chain = as_chain(key)
    keys, adds, n = _chain_args(chain, x.device)
    rows, offset = _rows_arg(row_offset, b, x.device)
    stream = _build.stream_of(x)
    skey = (x.device, stream.value)
    best, ticket = _scratch.get(skey, (None, None))
    if best is None or best.numel() < b:
        if best is not None:
            _retired.append((best, ticket))
        best = torch.zeros(max(b, 64), dtype=torch.int64, device=x.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=x.device)
        _scratch[skey] = (best, ticket)
    out = torch.empty(b, dtype=torch.int64, device=x.device)
    lib = _lib()
    rc = lib.gumbel_argmax(_build.ptr(x), *keys, rows, _build.ptr(out),
                           _build.ptr(best), _build.ptr(ticket), x.stride(0),
                           b, v, *adds, n, int(chain.then_split), offset,
                           stream)
    _build.check(lib, rc, "gumbel_argmax")
    gumbel_argmax.launches += 1
    return out


@counted
def threefry_noise(key, shape, mode: str = "gumbel", row_offset=0,
                   device="cuda"):
    """The (B, V) noise of a draw with ``key`` on ``device``: its bits
    (int64), its uniforms on [0, 1) or [tiny, 1), or its Gumbel noise
    (float32). A CPU device runs ``threefry_noise_plain``."""
    device = torch.device(device)
    if mode not in NOISE_MODES:
        raise ValueError(f"threefry_noise: unknown mode {mode!r}")
    if device.type == "cpu":
        return threefry_noise_plain(key, shape, mode, row_offset)
    chain = as_chain(key)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if chain.then_split:
        raise ValueError("threefry_noise: a noise draw moves no key chain")
    b, v = shape
    keys, adds, n = _chain_args(chain, device)
    rows, offset = _rows_arg(row_offset, b, device)
    out = torch.empty((b, v), device=device,
                      dtype=torch.int64 if mode == "bits" else torch.float32)
    lib = _lib()
    rc = lib.threefry_noise(*keys, rows, _build.ptr(out), b, v, *adds, n,
                            offset, NOISE_MODES.index(mode),
                            _build.stream_of(out))
    _build.check(lib, rc, "threefry_noise")
    threefry_noise.launches += 1
    return out
