"""Port ops (norms, rotary, attention) vs the JAX ops, float32, atol 1e-5."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.ops import attention as jattn
from qwen3_asr_rs_tpu.ops import norms as jnorms
from qwen3_asr_rs_tpu.ops import rotary as jrot
from qwen3_asr_rs_tpu_torch.ops import attention as tattn
from qwen3_asr_rs_tpu_torch.ops import norms as tnorms
from qwen3_asr_rs_tpu_torch.ops import rotary as trot

T = torch.from_numpy


def test_norms_match_jax(rng):
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal(64).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    np.testing.assert_allclose(
        tnorms.rms_norm(T(x), T(w), 1e-6).numpy(),
        np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-6)),
        atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        tnorms.layer_norm(T(x), T(w), T(b)).numpy(),
        np.asarray(jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))),
        atol=1e-5, rtol=1e-5)
    assert tnorms.rms_norm(T(x).bfloat16(), T(w)).dtype == torch.bfloat16


@pytest.mark.parametrize("interleaved", [False, True])
def test_rotary_tables_and_apply_match_jax(rng, interleaved):
    kw = dict(head_dim=16, rope_theta=10000.0, mrope_section=(3, 3, 2),
              interleaved=interleaved, max_position=64)
    jt, tt = jrot.RotaryTable(**kw), trot.RotaryTable(**kw)
    np.testing.assert_array_equal(tt.cos_table.numpy(), np.asarray(jt.cos_table))
    pos1 = np.array([0, 3, 17, 63])
    pos3 = np.stack([pos1, pos1[::-1], np.array([5, 5, 9, 1])])
    for pos in (pos1, pos3):
        jc, js = jt.lookup(jnp.asarray(pos))
        tc, ts = tt.lookup(T(pos))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    c, s = tt.lookup_pos(17)
    np.testing.assert_array_equal(c.numpy(), tt.lookup(T(np.array([17])))[0])
    x = rng.standard_normal((2, 4, 3, 16)).astype(np.float32)
    jc, js = jt.lookup(jnp.asarray(pos1))
    np.testing.assert_allclose(
        trot.apply_rotary(T(x), T(np.array(jc)), T(np.array(js))).numpy(),
        np.asarray(jrot.apply_rotary(jnp.asarray(x), jc, js)),
        atol=1e-6)


@pytest.mark.parametrize(
    "causal,kv_valid,kv_start",
    [(False, None, None), (True, None, None), (False, [5, 9], None),
     (True, None, [0, 3]), (True, [7, 9], [2, 0])],
)
def test_attention_matches_jax(rng, causal, kv_valid, kv_start):
    b, s, hq, hkv, d = 2, 9, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    jkw = dict(causal=causal, impl="dense",
               kv_valid=None if kv_valid is None else jnp.asarray(kv_valid),
               kv_start=None if kv_start is None else jnp.asarray(kv_start))
    tkw = dict(causal=causal, impl="dense",
               kv_valid=None if kv_valid is None else torch.tensor(kv_valid),
               kv_start=None if kv_start is None else torch.tensor(kv_start))
    ref = np.asarray(jattn.attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), **jkw))
    got = tattn.attention(T(q), T(k), T(v), **tkw).numpy()
    assert np.isfinite(got).all()  # fully masked rows stay NaN-free
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)


def test_dense_attention_bool_and_per_head_masks(rng):
    b, s, hq, hkv, d = 1, 6, 4, 2, 8
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    for mask in (rng.random((b, 1, s, s)) > 0.3, rng.random((b, hq, s, s)) > 0.3):
        ref = jattn.dense_attention(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), mask=jnp.asarray(mask))
        got = tattn.dense_attention(T(q), T(k), T(v), mask=T(mask))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


def test_auto_dispatch_rule_matches_jax(monkeypatch):
    for args in ((1, 16, 4736, 4736), (1, 16, 4095, 4095), (8, 16, 2048, 2048),
                 (1, 16, 432, 432)):
        for on in (True, False):
            assert (tattn.auto_attention_impl(*args, on_cuda=on)
                    == jattn.auto_attention_impl(*args, on_tpu=on))
    monkeypatch.setenv("ASR_ATTN_THRESHOLD", "100")
    assert tattn.auto_attention_impl(1, 4, 100, 100, on_cuda=True) == "flash"
    assert tattn.auto_attention_impl(1, 4, 100, 100, on_cuda=False) == "dense"


def test_attention_env_forces_flash_plain_on_cpu(rng, monkeypatch):
    """ASR_ATTN_IMPL=flash on CPU tensors runs K3's plain version."""
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention,
    )

    q = T(rng.standard_normal((1, 5, 2, 8)).astype(np.float32))
    k = T(rng.standard_normal((1, 5, 1, 8)).astype(np.float32))
    before = flash_attention.launches
    monkeypatch.setenv("ASR_ATTN_IMPL", "flash")
    got = tattn.attention(q, k, k, causal=True)
    monkeypatch.setenv("ASR_ATTN_IMPL", "dense")
    ref = tattn.attention(q, k, k, causal=True)
    assert torch.equal(got, ref)
    assert flash_attention.launches == before  # no kernel launch on CPU
