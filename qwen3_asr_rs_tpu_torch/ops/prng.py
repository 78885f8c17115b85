"""JAX's threefry random stream in torch.

The JAX package draws from ``jax.random`` with the threefry2x32 key type
and partitionable random bits (``jax_threefry_partitionable``, the
default): every key operation it uses is threefry2x32 of a key and a
pair of 32-bit counter words, which 32-bit integer arithmetic computes
exactly on any device. This module repeats those operations, so that a
seed gives the port the JAX package's samples:

  * a key is a ``(..., 2)`` int64 tensor of two 32-bit words;
    ``prng_key(seed)`` is JAX's ``PRNGKey(seed)``: ``[0, seed mod 2^32]``;
  * ``fold_in(key, d)`` is ``threefry2x32(key, (0, d))``, and
    ``split(key, n)[i]`` equals ``fold_in(key, i)``;
  * ``random_bits(key, shape)`` is ``y0 ^ y1`` of ``threefry2x32(key,
    (hi, lo))``, (hi, lo) each element's row-major flat index;
  * ``uniform`` puts the top 23 bits into the mantissa of a float in
    [1, 2) and subtracts 1, then ``max(minval, f * (maxval - minval) +
    minval)``; ``gumbel`` is ``-log(-log(uniform(tiny, 1)))`` (JAX's
    "low" mode); ``categorical`` is ``argmax(gumbel + logits)``, ties to
    the lowest index.

Words below 2^32 stay in int64 tensors and are masked after each add and
shift, so no signed value wraps: the CPU and the card give the same bits.

A draw on the card takes its key as a ``KeyChain``: a base key on the
device and the ``fold_in`` data to apply to it in order (ints, device
counters, or a device counter plus an int). The draw kernel
(``ops/kernels/gumbel_argmax.py``) derives the key itself, so a step in a
CUDA graph draws with a key made from the step counter it advances,
without launches of its own; ``resolve()`` is the same key by plain ops.
"""

from __future__ import annotations

import dataclasses
import operator
from typing import Sequence, Union

import numpy as np
import torch

M32 = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KEY_PARITY = 0x1BD11BDA
FLOAT32_TINY = float(np.finfo(np.float32).tiny)


def prng_key(seed, device="cpu") -> torch.Tensor:
    """JAX's ``PRNGKey(seed)`` (threefry, 32-bit seeds): the (2,) key
    ``[0, seed mod 2^32]``. ``seed`` is an integer in [-2^63, 2^63): JAX
    raises OverflowError outside that range and TypeError for a value
    that is not an integer scalar, and so does this."""
    if isinstance(seed, (torch.Tensor, np.ndarray)) and seed.ndim:
        raise TypeError(
            "PRNGKey accepts a scalar seed, but was given an array of shape "
            f"{tuple(seed.shape)} != (). Use jax.vmap for batching")
    if isinstance(seed, torch.Tensor):
        seed = seed.item()
    if isinstance(seed, (float, np.floating)) or not isinstance(
            seed, (int, np.integer)):
        raise TypeError(f"PRNG key seed must be an integer; got {seed!r}")
    seed = operator.index(seed)
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    return torch.tensor([0, seed & M32], dtype=torch.int64, device=device)


def _add(a, b):
    return (a + b) & M32


def threefry2x32(key: torch.Tensor, x0, x1):
    """threefry2x32 of a (..., 2) key on counter words ``x0``, ``x1``
    (int64 tensors or ints in [0, 2^32), broadcast against the key's
    leading shape): 20 rounds with rotations 13, 15, 26, 6 / 17, 29, 16,
    24 and a key injection after every 4, as JAX's
    ``_threefry2x32_lowering``. Returns (y0, y1), int64 in [0, 2^32)."""
    k0, k1 = key[..., 0], key[..., 1]
    ks = (k0, k1, k0 ^ k1 ^ KEY_PARITY)
    x0 = _add(torch.as_tensor(x0, dtype=torch.int64, device=key.device), k0)
    x1 = _add(torch.as_tensor(x1, dtype=torch.int64, device=key.device), k1)
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = _add(x0, x1)
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x1 ^ x0
        x0 = _add(x0, ks[(i + 1) % 3])
        x1 = _add(x1, ks[(i + 2) % 3] + (i + 1))
    return x0, x1


def _data_word(data, device) -> torch.Tensor:
    """``fold_in``'s data as one word: JAX casts it to uint32 and raises
    OverflowError for a Python int outside [0, 2^32); a tensor's value is
    taken mod 2^32 (a device counter stays on the device)."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.int64) & M32
    data = operator.index(data)
    if not 0 <= data <= M32:
        raise OverflowError(
            f"Python integer {data} out of bounds for uint32")
    return torch.tensor(data, dtype=torch.int64, device=device)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """JAX's ``fold_in(key, data)``: ``threefry2x32(key, (0, data))`` as a
    new key. ``data``: an int in [0, 2^32) or an integer tensor (a
    device counter; its shape broadcasts against the key's leading
    shape)."""
    y0, y1 = threefry2x32(key, 0, _data_word(data, key.device))
    return torch.stack([y0, y1], -1)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """JAX's ``split(key, num)`` (partitionable): (num, 2) keys, row i
    ``fold_in(key, i)``."""
    i = torch.arange(num, dtype=torch.int64, device=key.device)
    y0, y1 = threefry2x32(key[None], 0, i)
    return torch.stack([y0, y1], -1)


def _counters(shape: Sequence[int], offset, device):
    """(hi, lo) words of each element's row-major flat index plus
    ``offset`` (an int, or an int64 tensor broadcast against ``shape``)."""
    shape = tuple(shape)
    n = int(np.prod(shape, dtype=np.int64))
    flat = torch.arange(n, dtype=torch.int64, device=device).reshape(shape)
    if isinstance(offset, torch.Tensor):
        flat = flat + offset.to(device=device, dtype=torch.int64)
    elif offset:
        flat = flat + int(offset)
    return flat >> 32, flat & M32


def random_bits(key: torch.Tensor, shape: Sequence[int],
                offset=0) -> torch.Tensor:
    """JAX's 32-bit ``random_bits(key, shape)`` (partitionable): int64
    values in [0, 2^32). ``offset`` is added to every flat index: a rank
    holding a block of a larger array draws that block's bits by its
    position in the whole array."""
    hi, lo = _counters(shape, offset, key.device)
    y0, y1 = threefry2x32(key, hi, lo)
    return y0 ^ y1


def uniform_from_bits(bits: torch.Tensor, minval: float = 0.0,
                      maxval: float = 1.0) -> torch.Tensor:
    """JAX's float32 ``uniform`` of given bits: the top 23 bits as the
    mantissa of a float in [1, 2), minus 1, then ``max(minval, f *
    (maxval - minval) + minval)``, the product and sum rounded once to
    float32 as XLA's fused multiply-add rounds them (exact in float64,
    then one rounding; the sampling draws' span is 1, where no rounding
    is left to differ)."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    u = (f.double() * span + lo).float()
    return torch.clamp(u, min=lo)


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, offset=0) -> torch.Tensor:
    """JAX's float32 ``uniform(key, shape, minval=, maxval=)``."""
    return uniform_from_bits(random_bits(key, shape, offset), minval, maxval)


def gumbel_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 Gumbel noise ("low" mode) of given bits:
    ``-log(-log(u))``, u uniform on [tiny, 1). Every value is finite: u
    runs from tiny to 1 - 2^-23."""
    return -torch.log(-torch.log(uniform_from_bits(bits, FLOAT32_TINY, 1.0)))


def gumbel(key: torch.Tensor, shape: Sequence[int], offset=0) -> torch.Tensor:
    """JAX's float32 ``gumbel(key, shape)``."""
    return gumbel_from_bits(random_bits(key, shape, offset))


def row_offsets(rows: int, cols: int, row_offset=0):
    """The flat-index offset of a (rows, cols) block whose row r is row
    ``row_offset + r`` of a wider array (an int), or row ``row_offset[r]``
    (a (rows,) int64 tensor): an int, or a (rows, 1) tensor."""
    if isinstance(row_offset, torch.Tensor):
        r = torch.arange(rows, dtype=torch.int64, device=row_offset.device)
        return ((row_offset.to(torch.int64) - r) * cols)[:, None]
    return int(row_offset) * cols


def categorical(key: torch.Tensor, logits: torch.Tensor,
                row_offset=0) -> torch.Tensor:
    """JAX's ``categorical(key, logits)`` over the last axis of (V,) or
    (B, V) float32 logits: ``argmax(gumbel(key, logits.shape) + logits)``
    with ties to the lowest index. ``row_offset``: (B, V) rows draw as
    rows of a wider array (``row_offsets``)."""
    v = logits.shape[-1]
    b = logits.shape[0] if logits.ndim == 2 else 1
    off = row_offsets(b, v, row_offset)
    if logits.ndim == 1 and isinstance(off, torch.Tensor):
        off = off[0]
    g = gumbel(key, logits.shape, off)
    return torch.argmax(g + logits, dim=-1)


# a fold_in datum: an int, a device counter, or (device counter, int) for
# their sum
Datum = Union[int, torch.Tensor, tuple]


@dataclasses.dataclass(frozen=True)
class KeyChain:
    """``fold_in(... fold_in(base, data[0]) ..., data[-1])``, not computed
    yet: the draw kernel derives it in registers from ``base`` (a (2,)
    key on the device) and the data, each an int in [0, 2^32), a 0-d
    integer tensor, or a (0-d tensor, int) pair for their sum.

    ``then_split``: the draw uses ``fold_in(chain, 1)`` and, once every
    element has read the key, ``base`` becomes ``fold_in(base, 0)`` in
    place: JAX's ``key, sub = split(key)`` then a draw with ``sub``
    (the data must be empty)."""

    base: torch.Tensor
    data: tuple = ()
    then_split: bool = False

    def __post_init__(self):
        if self.then_split and self.data:
            raise ValueError("KeyChain: then_split takes no fold_in data")
        if len(self.data) > MAX_CHAIN:
            raise ValueError(
                f"KeyChain: at most {MAX_CHAIN} fold_in data, got "
                f"{len(self.data)}")

    def resolve(self) -> torch.Tensor:
        """The draw's key by plain ops."""
        key = self.base
        for d in self.data:
            key = fold_in(key, datum_value(d))
        return fold_in(key, 1) if self.then_split else key

    def advance(self) -> None:
        """``then_split``'s update of ``base`` by plain ops."""
        if self.then_split:
            self.base.copy_(fold_in(self.base, 0))


MAX_CHAIN = 4


def datum_value(d: Datum):
    """A fold_in datum's value: an int or a tensor."""
    if isinstance(d, tuple):
        t, add = d
        return t + add
    return d


def as_chain(key) -> KeyChain:
    """A key tensor or a ``KeyChain`` as a ``KeyChain``."""
    return key if isinstance(key, KeyChain) else KeyChain(key)
