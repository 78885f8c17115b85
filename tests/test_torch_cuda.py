"""The CUDA kernels against their plain PyTorch versions, on a GPU.

Marked ``cuda``: they skip without a CUDA device. This file imports no
JAX, so it runs on a GPU machine without jax (tests/conftest.py imports
jax, hence ``--noconftest``):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import pytest
import torch

from qwen3_asr_rs_tpu.config import TextDecoderConfig
from qwen3_asr_rs_tpu_torch.ops.kernels.decode_attention import (
    decode_attention,
    decode_attention_plain,
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


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 3e-2)])
def test_cuda_decode_attention_matches_plain(cuda, dtype, atol):
    g = torch.Generator(device=cuda).manual_seed(0)
    L, B, Hq, Hkv, S, D = 3, 2, 16, 8, 200, 128
    ks = torch.randn((L, B, Hkv, S, D), generator=g, device=cuda).to(dtype)
    vs = torch.randn_like(ks)
    q = torch.randn((B, Hq, D), generator=g, device=cuda).to(dtype)
    k_self = torch.randn((B, Hkv, D), generator=g, device=cuda).to(dtype)
    v_self = torch.randn_like(k_self)
    start = torch.tensor([0, 70], dtype=torch.int32, device=cuda)
    end = torch.tensor([133, 70], dtype=torch.int32, device=cuda)
    n = decode_attention.launches
    got = decode_attention(q, ks, vs, k_self, v_self, 2, start, end)
    assert decode_attention.launches == n + 1
    ref = decode_attention_plain(q, ks, vs, k_self, v_self, 2, start, end)
    assert (got.float() - ref.float()).abs().max() <= atol


@pytest.mark.cuda
def test_cuda_decode_layers_matches_plain(cuda):
    cfg = dataclasses.replace(TextDecoderConfig(), num_hidden_layers=2,
                              vocab_size=64)
    layers = to_torch(init_decoder_params_np(cfg), torch.float32,
                      cuda)["layers"]
    g = torch.Generator(device=cuda).manual_seed(1)
    shape = (2, 1, cfg.num_key_value_heads, 96, cfg.head_dim)
    kc = torch.randn(shape, generator=g, device=cuda)
    vc = 0.05 * torch.randn(shape, generator=g, device=cuda)
    x = 0.02 * torch.randn((1, cfg.hidden_size), generator=g, device=cuda)
    cos, sin = torch.ones((1, cfg.head_dim), device=cuda), torch.zeros(
        (1, cfg.head_dim), device=cuda)
    n, n_attn = decode_layers_fused.launches, decode_attention.launches
    got = decode_layers_fused(x, cos, sin, layers, kc, vc, 3, 77, eps=1e-6)
    assert decode_layers_fused.launches == n + 1
    # the C entry counts its launches of K2's kernels: one per layer
    assert decode_attention.launches == n_attn + 2
    idx = lambda v: torch.tensor([v], dtype=torch.int32, device=cuda)
    ref = decode_layers_fused_plain(x, cos, sin, layers, kc, vc, idx(3),
                                    idx(77), eps=1e-6)
    for a, b in zip(got, ref):
        assert (a - b).abs().max() <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [dict(causal=True),
                                dict(causal=False, kv_valid=[100])])
def test_cuda_flash_attention_matches_plain(cuda, kw):
    g = torch.Generator(device=cuda).manual_seed(2)
    q = torch.randn((1, 300, 16, 128), generator=g, device=cuda)
    k = torch.randn((1, 300, 8, 128), generator=g, device=cuda)
    v = torch.randn((1, 300, 8, 128), generator=g, device=cuda)
    kv_valid = kw.get("kv_valid")
    kv_valid = None if kv_valid is None else torch.tensor(kv_valid, device=cuda)
    n = flash_attention.launches
    got = flash_attention(q, k, v, kv_valid, causal=kw["causal"])
    assert flash_attention.launches == n + 1
    ref = flash_attention_plain(q, k, v, kv_valid, causal=kw["causal"])
    assert (got - ref).abs().max() <= 1e-4
