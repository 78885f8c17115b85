"""The port's checkpoint export against the JAX package's (CPU).

Files the port writes (``weights/export.py``, its own safetensors
writer) hold the same tensors as the JAX export of the same parameters,
read by JAX's loader (the ``safetensors`` package) and by the port's;
single-file and sharded with the index JSON, tied (no lm_head written,
as JAX) and untied, float32 and bf16. A trained state exported then
loads into ``AsrEngine``, which transcribes.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.weights import export as jexport
from qwen3_asr_rs_tpu.weights import loader as jloader
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.training import adamw, make_train_step
from qwen3_asr_rs_tpu_torch.weights import export as texport
from qwen3_asr_rs_tpu_torch.weights import loader as tloader
from qwen3_asr_rs_tpu_torch.weights.convert import (
    from_torch,
    init_decoder_params_np,
    init_encoder_params_np,
    to_torch,
)

from test_engine_e2e import MockTokenizer
from test_training import make_batch


def _untie(cfg):
    text = dataclasses.replace(cfg.text, tie_word_embeddings=False)
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=text))


def _configs(tied):
    j, t = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    return (j, t) if tied else (_untie(j), _untie(t))


def _np_params(tcfg):
    return (init_encoder_params_np(tcfg.audio),
            init_decoder_params_np(tcfg.text))


def _jax_tree(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.mark.parametrize("tied", [True, False])
@pytest.mark.parametrize("shard", [None, 20000])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_export_equals_jax_export(tmp_path, tied, shard, dtype):
    jcfg, tcfg = _configs(tied)
    enc, dec = _np_params(tcfg)
    jexport.save_checkpoint(tmp_path / "jax", _jax_tree(enc, dtype),
                            _jax_tree(dec, dtype), jcfg,
                            max_shard_bytes=shard)
    tdt = getattr(torch, dtype)
    texport.save_checkpoint(tmp_path / "port", to_torch(enc, tdt),
                            to_torch(dec, tdt), tcfg, max_shard_bytes=shard)
    if shard:
        idx = [json.loads((tmp_path / d / "model.safetensors.index.json")
                          .read_text()) for d in ("jax", "port")]
        assert idx[1] == idx[0]
        assert len(set(idx[1]["weight_map"].values())) > 1
    assert (json.loads((tmp_path / "port" / "config.json").read_text())
            == json.loads((tmp_path / "jax" / "config.json").read_text()))

    want = jloader.load_checkpoint(tmp_path / "jax")
    got = jloader.load_checkpoint(tmp_path / "port")
    assert got.keys() == want.keys()
    assert (jloader.LM_HEAD_KEY in got) == (not tied)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        np.testing.assert_array_equal(np.asarray(got[k], np.float32),
                                      np.asarray(want[k], np.float32), k)

    # the port's loader reads the port's files back to the exported tree
    tenc, tdec = tloader.load_model_params(tmp_path / "port", tcfg, tdt)
    for a, b in ((tenc, to_torch(enc, tdt)), (tdec, to_torch(dec, tdt))):
        fa, fb = from_torch(a), from_torch(b)
        assert jax.tree_util.tree_structure(fa) == \
            jax.tree_util.tree_structure(fb)
        jax.tree_util.tree_map(np.testing.assert_array_equal, fa, fb)
    assert (tdec["lm_head"] is tdec["embed"]) == tied


def test_write_safetensors_reads_back_every_dtype(tmp_path):
    from safetensors.numpy import load_file

    tensors = {
        "f32": torch.arange(6, dtype=torch.float32).reshape(2, 3),
        "bf16": torch.tensor([1.5, -2.0, 3.25], dtype=torch.bfloat16),
        "i8": torch.tensor([[-7, 7]], dtype=torch.int8),
        "scalar": torch.tensor(4.0),
        "t": torch.arange(12, dtype=torch.float32).reshape(3, 4).T,
    }
    texport.write_safetensors(tmp_path / "x.safetensors", tensors)
    got = tloader.read_safetensors(tmp_path / "x.safetensors")
    assert got.keys() == tensors.keys()
    for k, t in tensors.items():
        assert got[k].dtype == t.dtype and torch.equal(got[k], t), k
    ref = load_file(str(tmp_path / "x.safetensors"))
    np.testing.assert_array_equal(ref["t"], tensors["t"].numpy())
    np.testing.assert_array_equal(ref["i8"], tensors["i8"].numpy())


def test_trained_state_exports_and_serves(tmp_path, rng):
    """Export after a train step (the tied head trained apart is dropped,
    as JAX's export drops it), then AsrEngine loads the directory: its
    tensors equal the exported ones, and it transcribes."""
    cfg = tconfig.tiny_test_config()
    cfg = dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=dataclasses.replace(
            cfg.text, vocab_size=151936)))  # the special tokens embed
    enc, dec = _np_params(cfg)
    step = make_train_step(cfg, adamw(1e-3), max_position=256, device="cpu")
    state = step.init({"encoder": to_torch(enc, torch.float32),
                       "decoder": to_torch(dec, torch.float32)})
    state, _ = step(state, make_batch(cfg, 2, rng))
    texport.save_checkpoint(tmp_path / "m", state.params["encoder"],
                            state.params["decoder"], cfg)
    engine = AsrEngine(tmp_path / "m", dtype=torch.float32, max_new_tokens=4,
                       chunk_buckets=(2, 4), tokenizer=MockTokenizer(),
                       device="cpu")
    enc_w, dec_w = (from_torch(state.params[k]) for k in ("encoder",
                                                         "decoder"))
    assert not np.array_equal(dec_w["lm_head"], dec_w["embed"])
    dec_w["lm_head"] = dec_w["embed"]  # tied: the loader reuses embed
    for got, want in ((engine.enc_params, enc_w), (engine.dec_params, dec_w)):
        jax.tree_util.tree_map(np.testing.assert_array_equal,
                               from_torch(got), want)
    result = engine.transcribe_samples(
        (rng.standard_normal(16000) * 0.1).astype(np.float32))
    assert isinstance(result.text, str)
