"""The kernels' plain PyTorch versions vs the JAX Pallas kernels.

The JAX kernels run in Pallas interpret mode on the CPU, as the JAX
package's own kernel tests run them. float32, atol/rtol 1e-5. The CUDA
kernels themselves are compared with these plain versions on the GPU by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.config import tiny_test_config
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.ops.pallas.decode_attention import (
    decode_attention_dma as jax_decode_attention_dma,
)
from qwen3_asr_rs_tpu.ops.pallas.decode_layer import (
    decode_layers_fused as jax_decode_layers_fused,
)
from qwen3_asr_rs_tpu.ops.pallas.flash_attention import (
    flash_attention as jax_flash_attention,
)
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
    decode_attention_dma,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_layer import (
    decode_layers_fused,
    decode_layers_fused_plain,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    to_torch,
)

TOL = dict(atol=1e-5, rtol=1e-5)
T = torch.from_numpy


def _counts():
    return (decode_attention_dma.launches, decode_layers_fused.launches,
            flash_attention.launches)


@pytest.mark.parametrize("start,end", [(None, [37, 61]), ([0, 5], [17, 64]),
                                       ([9, 0], [9, 1])])
def test_decode_attention_plain_matches_pallas(rng, start, end):
    L, B, Hq, Hkv, S, D = 2, 2, 4, 2, 64, 16
    q = rng.standard_normal((B, Hq, D)).astype(np.float32)
    ks = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    vs = rng.standard_normal((L, B, Hkv, S, D)).astype(np.float32)
    k_self = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    v_self = rng.standard_normal((B, Hkv, D)).astype(np.float32)
    st = None if start is None else np.asarray(start, np.int32)
    en = np.asarray(end, np.int32)
    ref = jax_decode_attention_dma(
        jnp.asarray(q), jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(k_self),
        jnp.asarray(v_self), 1, None if st is None else jnp.asarray(st),
        jnp.asarray(en), block_s=16, interpret=True,
    )
    before = _counts()
    got = decode_attention_dma(T(q), T(ks), T(vs), T(k_self), T(v_self), 1,
                               None if st is None else T(st), T(en))
    assert _counts() == before  # CPU tensors run the plain version
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize(
    "b,s_max,start,end",
    [(1, 48, None, 20), (1, 48, 7, 41), (2, 32, [0, 4], [1, 30])],
)
def test_decode_layers_plain_matches_pallas(rng, b, s_max, start, end):
    cfg = tiny_test_config().text
    jparams = init_decoder_params(cfg, dtype=jnp.float32)
    layers = to_torch(init_decoder_params_np(tconfig.tiny_test_config().text),
                      torch.float32)["layers"]
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s_max,
             cfg.head_dim)
    kc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    vc = (rng.standard_normal(shape) * 0.3).astype(np.float32)
    x = rng.standard_normal((b, cfg.hidden_size)).astype(np.float32)
    ang = rng.uniform(0, 6, (b, cfg.head_dim // 2)).astype(np.float32)
    cos = np.concatenate([np.cos(ang)] * 2, -1)
    sin = np.concatenate([np.sin(ang)] * 2, -1)
    st = None if start is None else np.broadcast_to(start, (b,)).astype(np.int32)
    en = np.broadcast_to(end, (b,)).astype(np.int32)
    ref = jax_decode_layers_fused(
        jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin), jparams["layers"],
        jnp.asarray(kc), jnp.asarray(vc),
        None if st is None else jnp.asarray(st), jnp.asarray(en),
        eps=cfg.rms_norm_eps, interpret=True,
    )
    before = _counts()
    got = decode_layers_fused(
        T(x), T(cos), T(sin), layers, T(kc), T(vc),
        None if st is None else T(st), T(en), eps=cfg.rms_norm_eps,
    )
    assert _counts() == before
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)


@pytest.mark.parametrize(
    "causal,kv_valid,kv_start",
    [(True, None, None), (False, [30, 40], None), (True, None, [0, 7]),
     (True, [33, 21], [3, 0])],
)
def test_flash_attention_plain_matches_pallas(rng, causal, kv_valid, kv_start):
    b, s, hq, hkv, d = 2, 40, 4, 2, 16
    q = rng.standard_normal((b, s, hq, d)).astype(np.float32)
    k = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, d)).astype(np.float32)
    jv = None if kv_valid is None else jnp.asarray(kv_valid, jnp.int32)
    js = None if kv_start is None else jnp.asarray(kv_start, jnp.int32)
    ref = np.asarray(jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jv, js,
        causal=causal, block_q=16, block_k=16, interpret=True,
    ))
    before = _counts()
    got = flash_attention(
        T(q), T(k), T(v),
        None if kv_valid is None else torch.tensor(kv_valid),
        None if kv_start is None else torch.tensor(kv_start), causal=causal,
    ).numpy()
    assert _counts() == before
    assert np.isfinite(got).all()
    # compare rows that have at least one attendable key; the others are
    # padding whose (finite) values depend on the block schedule
    row = np.arange(s)
    ok = np.ones((b, s), bool)
    for i in range(b):
        lo = 0 if kv_start is None else kv_start[i]
        hi = s if kv_valid is None else kv_valid[i]
        ok[i] = (row >= lo) if causal else True
        ok[i] &= lo < hi
    np.testing.assert_allclose(got[ok], ref[ok], **TOL)


def test_wrappers_reject_other_devices():
    meta = torch.empty((1, 2, 128), device="meta")
    with pytest.raises(ValueError, match="not supported"):
        decode_attention_dma(meta, meta, meta, meta, meta, 0, None, 1)
    with pytest.raises(ValueError, match="not supported"):
        flash_attention(meta[None], meta[None], meta[None])
    with pytest.raises(ValueError, match="not supported"):
        decode_layers_fused(meta[0], meta[0], meta[0], {}, meta, meta, None, 1,
                            eps=1e-6)
