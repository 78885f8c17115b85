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


_JAX_SHAPES = ((1, 16, 4736, 4736), (1, 16, 4095, 4095), (8, 16, 2048, 2048),
               (1, 16, 432, 432))


@pytest.mark.parametrize("args,on", [(a, on) for a in _JAX_SHAPES
                                     for on in (True, False)])
def test_auto_dispatch_rule_matches_jax(args, on):
    """float32 calls (on CUDA and off it) keep the JAX package's
    score-bytes rule."""
    assert (tattn.auto_attention_impl(*args, on_cuda=on, dtype=torch.float32,
                                      head_dim=128, grad=False)
            == jattn.auto_attention_impl(*args, on_tpu=on))


@pytest.mark.parametrize("on,want", [(True, "flash"), (False, "dense")])
def test_auto_dispatch_float32_threshold_env(monkeypatch, on, want):
    """ASR_ATTN_THRESHOLD moves the float32 rule's crossover."""
    monkeypatch.setenv("ASR_ATTN_THRESHOLD", "100")
    assert tattn.auto_attention_impl(1, 4, 100, 100, on_cuda=on,
                                     dtype=torch.float32, head_dim=128,
                                     grad=False) == want


@pytest.mark.parametrize("args,kw,want", [
    # bf16 on CUDA: K3 at every shape, the batched prefill's included
    ((32, 16, 432, 432), dict(on_cuda=True), "flash"),
    ((1, 16, 432, 432), dict(on_cuda=True), "flash"),
    ((128, 14, 104, 104), dict(on_cuda=True, head_dim=64), "flash"),
    ((1, 16, 4736, 4736), dict(on_cuda=True), "flash"),
    # the CPU stays dense
    ((32, 16, 432, 432), dict(on_cuda=False), "dense"),
    ((1, 16, 4736, 4736), dict(on_cuda=False), "dense"),
    # K3 has no backward: a gradient keeps every dtype dense
    ((32, 16, 432, 432), dict(on_cuda=True, grad=True), "dense"),
    ((1, 16, 4736, 4736), dict(on_cuda=True, grad=True), "dense"),
    ((1, 16, 4736, 4736), dict(on_cuda=True, grad=True,
                               dtype=torch.float32), "dense"),
    # a head size K3 does not take
    ((32, 4, 432, 432), dict(on_cuda=True, head_dim=16), "dense"),
])
def test_auto_dispatch_rule_bf16_cuda(monkeypatch, args, kw, want):
    """The CUDA rule measured on the card (scripts/attention_crossover.py):
    bf16 without a gradient takes K3 wherever K3 takes the head size;
    ASR_ATTN_THRESHOLD does not move it."""
    monkeypatch.setenv("ASR_ATTN_THRESHOLD", "100000")
    kw = dict(dict(dtype=torch.bfloat16, head_dim=128, grad=False), **kw)
    assert tattn.auto_attention_impl(*args, **kw) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("requires_grad,grad_mode", [
    (False, True), (True, True), (True, False)])
def test_attention_passes_what_it_sees_to_the_rule(rng, monkeypatch, dtype,
                                                   requires_grad, grad_mode):
    """``attention`` hands the rule q's shapes, dtype, head size and device,
    and ``grad`` only where autograd would pass through the call; each
    call adds 1 to the tracer's counter of the path taken."""
    from qwen3_asr_rs_tpu_torch.utils import tracing

    seen = []

    def rule(*args, **kw):
        seen.append((args, kw))
        return "dense"

    monkeypatch.setattr(tattn, "auto_attention_impl", rule)
    monkeypatch.delenv("ASR_ATTN_IMPL", raising=False)
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", tracing.Timings())
    monkeypatch.setattr(tracing, "_enabled", True)
    q = T(rng.standard_normal((3, 7, 4, 8)).astype(np.float32)).to(dtype)
    k = T(rng.standard_normal((3, 5, 2, 8)).astype(np.float32)).to(dtype)
    k.requires_grad_(requires_grad)
    with torch.set_grad_enabled(grad_mode):
        tattn.attention(q, k, k)
        tattn.attention(q, k, k, impl="dense")
    assert seen == [((3, 4, 7, 5, False),
                     dict(dtype=dtype, head_dim=8,
                          grad=requires_grad and grad_mode))]
    assert dict(tracing.GLOBAL_TIMINGS.counters) == {"attention.dense": 2}


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
