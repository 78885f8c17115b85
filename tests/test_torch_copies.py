"""The port's copies of the JAX package's JAX-free modules (``config``,
``errors``, ``tokenizer``, ``audio``, ``runtime/longform``, ``utils/wer``)
against the originals, on the same inputs: equal results, exactly (the
long-form functions and the error rates are also held in
``test_torch_longform.py`` and ``test_torch_tracing.py``)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses
import json

import numpy as np
import pytest

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu import errors as jerrors
from qwen3_asr_rs_tpu import tokenizer as jtokenizer
from qwen3_asr_rs_tpu.audio import load as jload
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch import errors as terrors
from qwen3_asr_rs_tpu_torch import tokenizer as ttokenizer
from qwen3_asr_rs_tpu_torch.audio import load as tload


@pytest.mark.parametrize("make", ["AsrConfig", "tiny_test_config",
                                  "synthetic_17b_config"])
def test_configs_equal(make):
    ref, got = getattr(jconfig, make)(), getattr(tconfig, make)()
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.text.mrope_section() == ref.text.mrope_section()
    assert got.text.mrope_interleaved() == ref.text.mrope_interleaved()
    assert got.audio.tokens_per_chunk == ref.audio.tokens_per_chunk


def test_config_from_file_equal(tmp_path):
    """A config.json in the checkpoint's layout, with a field of another
    model family and a rope_scaling block, read by both."""
    d = {"thinker_config": {
        "audio_config": dict(dataclasses.asdict(
            jconfig.tiny_test_config().audio), unknown_field=3),
        "text_config": dict(
            dataclasses.asdict(jconfig.AsrConfig().text),
            rope_scaling={"mrope_section": [24, 20, 20],
                          "mrope_interleaved": True}),
    }}
    path = tmp_path / "config.json"
    path.write_text(json.dumps(d))
    ref, got = jconfig.AsrConfig.from_file(path), tconfig.AsrConfig.from_file(path)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    assert got.text.mrope_section() == ref.text.mrope_section()


def test_feat_extract_output_length_equal():
    for n in range(0, 3001):
        assert (tconfig.feat_extract_output_length(n)
                == jconfig.feat_extract_output_length(n))


@pytest.mark.parametrize("rate", [8000, 16000, 44100])
def test_load_audio_equal(tmp_path, rate):
    from test_audio_io import write_wav_pcm16

    samples = np.sin(np.arange(int(1.3 * rate)) * 2 * np.pi * 440 / rate)
    samples = samples * 0.4 + 0.05 * np.random.default_rng(rate).standard_normal(
        samples.shape)
    path = tmp_path / f"tone_{rate}.wav"
    write_wav_pcm16(path, samples, rate)
    ref, got = jload.load_audio(path, 16000), tload.load_audio(path, 16000)
    assert got.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(got, ref)
    with pytest.raises(terrors.AudioError):
        tload.load_audio(tmp_path / "missing.wav", 16000)


def test_tokenizer_special_ids_and_errors_equal():
    ids = {n: v for n, v in vars(jtokenizer).items() if n.endswith("_TOKEN_ID")}
    assert len(ids) >= 10
    assert {n: getattr(ttokenizer, n) for n in ids} == ids
    for name, cls in vars(jerrors).items():
        if isinstance(cls, type) and issubclass(cls, Exception):
            tcls = getattr(terrors, name)
            assert [c.__name__ for c in tcls.__mro__] == [
                c.__name__ for c in cls.__mro__]


@pytest.mark.parametrize("path", ["runtime/longform.py", "utils/wer.py"])
def test_copies_hold_the_originals_code(path):
    """Copies whose relative imports name the same modules in both
    packages: the original's code (its syntax tree, docstrings included;
    comments may differ) under a one-line note naming it."""
    import ast
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    copy = (repo / "qwen3_asr_rs_tpu_torch" / path).read_text()
    assert copy.startswith(f"# A copy of qwen3_asr_rs_tpu/{path}")
    original = (repo / "qwen3_asr_rs_tpu" / path).read_text()
    assert ast.dump(ast.parse(copy)) == ast.dump(ast.parse(original))
