"""K6: the port's ``decode_attention_slab`` and its single-layer wrapper
``decode_attention`` (their plain versions, on the CPU) against the JAX
package's Pallas kernels of the same names in interpret mode, on the
cases of tests/test_decode_attention.py: head_dim 64 and 128, ragged
per-row starts, slab lengths that are no multiple of the block. float32,
atol/rtol 1e-5 (the same float32 math; the two sides add in other
orders)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops.pallas import decode_attention as jattn
from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as tattn

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy

CASES = [
    (1, 584, 16, 8, 128, None, [450], 256),
    (2, 304, 16, 8, 128, [0, 37], [296, 120], 128),
    (1, 64, 4, 2, 64, None, [64], 64),
    (3, 136, 8, 4, 128, [5, 0, 60], [100, 136, 61], 64),
]


def _counts():
    return (tattn.decode_attention.launches,
            tattn.decode_attention_slab.launches,
            tattn.decode_attention_dma.launches)


@pytest.mark.parametrize("b,s,hq,hkv,d,starts,ends,block_s", CASES)
def test_slab_and_single_layer_match_pallas(rng, b, s, hq, hkv, d, starts,
                                            ends, block_s):
    q = (rng.standard_normal((b, hq, d)) * 0.5).astype(np.float32)
    k3 = (rng.standard_normal((3, b, hkv, s, d)) * 0.3).astype(np.float32)
    v3 = (rng.standard_normal((3, b, hkv, s, d)) * 0.3).astype(np.float32)
    k_self = (rng.standard_normal((b, hkv, d)) * 0.3).astype(np.float32)
    v_self = (rng.standard_normal((b, hkv, d)) * 0.3).astype(np.float32)
    jstart = None if starts is None else jnp.asarray(starts, jnp.int32)
    tstart = None if starts is None else torch.tensor(starts)
    jend, tend = jnp.asarray(ends, jnp.int32), torch.tensor(ends)

    ref_slab = jattn.decode_attention_slab(
        jnp.asarray(q), jnp.asarray(k3), jnp.asarray(v3), jnp.asarray(k_self),
        jnp.asarray(v_self), jnp.int32(1), jstart, jend, block_s=block_s,
        interpret=True)
    ref_one = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k3[2]), jnp.asarray(v3[2]),
        jnp.asarray(k_self), jnp.asarray(v_self), jstart, jend,
        block_s=block_s, interpret=True)

    before = _counts()
    got_slab = tattn.decode_attention_slab(
        T(q), T(k3), T(v3), T(k_self), T(v_self), 1, tstart, tend,
        block_s=block_s)
    got_one = tattn.decode_attention(T(q), T(k3[2]), T(v3[2]), T(k_self),
                                     T(v_self), tstart, tend, block_s=block_s)
    assert _counts() == before  # CPU tensors: the plain versions
    np.testing.assert_allclose(got_slab.numpy(), np.asarray(ref_slab), **TOL)
    np.testing.assert_allclose(got_one.numpy(), np.asarray(ref_one), **TOL)
    # the plain versions of the three entries agree on float slabs
    np.testing.assert_array_equal(
        got_slab.numpy(),
        tattn.decode_attention_dma_plain(T(q), T(k3), T(v3), T(k_self),
                                         T(v_self), 1, tstart, tend).numpy())
    np.testing.assert_array_equal(
        got_one.numpy(),
        tattn.decode_attention_slab_plain(T(q), T(k3), T(v3), T(k_self),
                                          T(v_self), 2, tstart, tend).numpy())


def test_int_end_and_scale_match_pallas(rng):
    """An int ``end`` for every row and an explicit softmax scale."""
    b, s, hq, hkv, d = 2, 100, 4, 2, 64
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    v = (rng.standard_normal((b, hkv, s, d)) * 0.3).astype(np.float32)
    k_self = rng.standard_normal((b, hkv, d)).astype(np.float32)
    v_self = rng.standard_normal((b, hkv, d)).astype(np.float32)
    ref = jattn.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(k_self),
        jnp.asarray(v_self), None, jnp.asarray([77, 77], jnp.int32),
        scale=0.3, block_s=32, interpret=True)
    got = tattn.decode_attention(T(q), T(k), T(v), T(k_self), T(v_self),
                                 None, 77, scale=0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_slab_entries_take_float_slabs_only():
    q = torch.zeros((1, 4, 64))
    slab = torch.zeros((1, 1, 2, 8, 64), dtype=torch.int8)
    kv = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="bf16/f32 slabs"):
        tattn.decode_attention_slab(q, slab, slab, kv, kv, 0, None, 4)
    with pytest.raises(ValueError, match="bf16/f32 slabs"):
        tattn.decode_attention(q, slab[0], slab[0], kv, kv, None, 4)
    meta = torch.empty((1, 4, 64), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        tattn.decode_attention_slab(meta, meta[None, None], meta[None, None],
                                    meta, meta, 0, None, 1)
