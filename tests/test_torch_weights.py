"""Port weights: numpy initialisers and the safetensors loader vs JAX."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.weights.export import save_checkpoint
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.errors import WeightsError
from qwen3_asr_rs_tpu_torch.weights import convert
from qwen3_asr_rs_tpu_torch.weights.loader import (
    load_checkpoint,
    load_model_params,
    read_safetensors,
)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _tiny(module, tied=True):
    """A package's ``tiny_test_config()``, untied unless ``tied``."""
    cfg = module.tiny_test_config()
    if tied:
        return cfg
    text = dataclasses.replace(cfg.text, tie_word_embeddings=False)
    return dataclasses.replace(
        cfg, thinker_config=dataclasses.replace(cfg.thinker_config,
                                                text_config=text)
    )


@pytest.mark.parametrize("tied", [True, False])
def test_numpy_init_matches_jax_bit_for_bit(tied):
    cfg, tcfg = _tiny(jconfig, tied), _tiny(tconfig, tied)
    for jax_fn, np_fn, sub, tsub, seed in (
        (init_encoder_params, convert.init_encoder_params_np, cfg.audio,
         tcfg.audio, 5),
        (init_decoder_params, convert.init_decoder_params_np, cfg.text,
         tcfg.text, 3),
    ):
        ref = _flat(jax_fn(sub, seed=seed, dtype=jnp.float32))
        got = _flat(np_fn(tsub, seed=seed))
        assert ref.keys() == got.keys()
        for k in ref:
            assert got[k].dtype == np.float32
            np.testing.assert_array_equal(np.asarray(ref[k]), got[k], err_msg=k)
    dec = convert.init_decoder_params(tcfg.text, dtype=torch.float32)
    assert (dec["lm_head"] is dec["embed"]) == tied


def test_numpy_init_real_layer_dims_match_jax():
    """Real 0.6B per-layer widths (one layer each, small vocab)."""
    def dims(module):
        base = module.AsrConfig()
        return (dataclasses.replace(base.audio, encoder_layers=1),
                dataclasses.replace(base.text, num_hidden_layers=1,
                                    vocab_size=64))

    for jax_fn, np_fn, sub, tsub in zip(
        (init_encoder_params, init_decoder_params),
        (convert.init_encoder_params_np, convert.init_decoder_params_np),
        dims(jconfig), dims(tconfig),
    ):
        ref = jax.tree_util.tree_leaves(jax_fn(sub, dtype=jnp.float32))
        got = jax.tree_util.tree_leaves(np_fn(tsub))
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_bf16_cast_matches_jax_bits():
    ref = _flat(init_decoder_params(jconfig.tiny_test_config().text,
                                    dtype=jnp.bfloat16))
    got = _flat(convert.init_decoder_params(tconfig.tiny_test_config().text,
                                            dtype=torch.bfloat16))
    for k in ref:
        a = np.asarray(ref[k]).view(np.uint16)
        b = got[k].view(torch.int16).numpy().view(np.uint16)
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize(
    "tied,shard_bytes,jdtype,tdtype",
    [
        (True, None, jnp.float32, torch.float32),
        (False, 20_000, jnp.float32, torch.float32),
        (True, None, jnp.bfloat16, torch.bfloat16),
    ],
)
def test_loader_reads_save_checkpoint(tmp_path, tied, shard_bytes, jdtype,
                                      tdtype):
    cfg = _tiny(jconfig, tied)
    enc = init_encoder_params(cfg.audio, dtype=jdtype)
    dec = init_decoder_params(cfg.text, dtype=jdtype)
    save_checkpoint(tmp_path, enc, dec, cfg, max_shard_bytes=shard_bytes)
    if shard_bytes:
        assert (tmp_path / "model.safetensors.index.json").exists()
    t_enc, t_dec = load_model_params(tmp_path, _tiny(tconfig, tied),
                                     dtype=tdtype)
    for ref, got in ((enc, t_enc), (dec, t_dec)):
        ref, got = _flat(ref), _flat(got)
        assert ref.keys() == got.keys()
        for k in ref:
            assert got[k].dtype == tdtype, k
            np.testing.assert_array_equal(
                np.asarray(ref[k].astype(jnp.float32)),
                got[k].float().numpy(), err_msg=k,
            )
    assert (t_dec["lm_head"] is t_dec["embed"]) == tied


def test_loader_adds_zero_attention_biases_and_rejects_missing(tmp_path):
    from qwen3_asr_rs_tpu_torch.weights.loader import (
        map_decoder_params,
        map_encoder_params,
    )

    cfg, tcfg = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    enc = init_encoder_params(cfg.audio, dtype=jnp.float32)
    enc["layers"]["k_b"] = enc["layers"]["k_b"] + 1.0
    dec = init_decoder_params(cfg.text, dtype=jnp.float32)
    save_checkpoint(tmp_path, enc, dec, cfg)
    tensors = load_checkpoint(tmp_path)
    for i in range(cfg.audio.encoder_layers):  # HF Whisper k_proj: no bias
        del tensors[f"thinker.audio_tower.layers.{i}.self_attn.k_proj.bias"]
    t_enc = map_encoder_params(tensors, tcfg, torch.float32)
    assert torch.equal(t_enc["layers"]["k_b"],
                       torch.zeros(cfg.audio.encoder_layers, cfg.audio.d_model))

    del tensors["thinker.model.norm.weight"]
    with pytest.raises(WeightsError, match="Missing weight"):
        map_decoder_params(tensors, tcfg)


def test_read_safetensors_rejects_bad_files(tmp_path):
    with pytest.raises(WeightsError):
        load_checkpoint(tmp_path)  # no checkpoint at all
    bad = tmp_path / "x.safetensors"
    bad.write_bytes(b"\x10\x00\x00\x00\x00\x00\x00\x00{not json}......")
    with pytest.raises(WeightsError):
        read_safetensors(bad)
