"""The plain float32 reference against the port's plain path, on the CPU
at tiny widths: the log-mel, the audio encoder, and the logits of a
prompt followed by tokens (the port's prefill, then its decode steps
teacher-forced on the same tokens)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from tiny import tiny_config

from harness.program import StubTokenizer
from harness.weights import make_weights

from qwen3_asr_rs_tpu_torch.config import AsrConfig
from qwen3_asr_rs_tpu_torch.features.mel import (
    create_mel_filterbank, log_mel_from_padded, pad_waveform)
from qwen3_asr_rs_tpu_torch.models.audio_encoder import AudioEncoder
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

from harness.spec import BENCH_DIR as BENCH, load_module

REF = load_module(BENCH / "reference" / "qwen3_asr.py")

# float32 on both sides; the two compute the same sums in other orders
# (an FFT against DFT products, windows apart against masked ones)
RTOL, ATOL = 1e-4, 1e-4


def _clip(seconds: float, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.standard_normal(int(seconds * 16000)).astype(np.float32) * 0.1


@pytest.fixture(scope="module")
def model():
    cfg = tiny_config()
    enc, dec = make_weights(cfg, 1234, "cpu")
    return cfg, enc, dec, REF.Reference(cfg, enc, dec, "cpu")


@pytest.mark.parametrize("seconds", [1.0, 2.37, 9.73])
def test_log_mel_matches_port(model, seconds):
    _, _, _, ref = model
    samples = _clip(seconds)
    wave, n_true = pad_waveform(samples)
    want = log_mel_from_padded(torch.from_numpy(wave), n_true,
                               torch.from_numpy(create_mel_filterbank(128)))
    got = ref.log_mel(samples)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seconds", [1.0, 3.41, 9.73, 17.2])
def test_encoder_matches_port(model, seconds):
    """Partial chunks, several windows and a partial last window."""
    cfg, enc, _, ref = model
    samples = _clip(seconds, 1)
    mel = ref.log_mel(samples)
    port = AudioEncoder(AsrConfig.from_dict(cfg).audio)
    cf = 100
    bucket = -(-mel.shape[1] // cf) * cf + cf  # a padded bucket
    padded = torch.nn.functional.pad(mel, (0, bucket - mel.shape[1]))
    flat, n_valid = port(enc, padded, mel.shape[1])
    got = ref.encode(mel)
    assert got.shape[0] == n_valid
    torch.testing.assert_close(got, flat[:n_valid], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seconds,n_tokens", [(2.5, 6), (9.0, 12)])
def test_continuation_logits_match_port(model, seconds, n_tokens):
    cfg, enc, dec, ref = model
    samples = _clip(seconds, 2)
    eng = AsrEngine(None, config=AsrConfig.from_dict(cfg), params=(enc, dec),
                    tokenizer=StubTokenizer(), device="cpu",
                    dtype=torch.float32, max_new_tokens=32)
    logits, cache, base = eng.prefill(samples)
    toks = torch.randint(0, 151936, (n_tokens,),
                         generator=torch.Generator().manual_seed(5))
    want = [logits[0]]
    for i, t in enumerate(toks):
        out, _ = eng.decoder.decode_step(eng.dec_params, t.reshape(1),
                                         base + i, cache)
        want.append(out[0])
    got = ref.continuation_logits(samples, toks.tolist())
    torch.testing.assert_close(got, torch.stack(want), rtol=RTOL, atol=ATOL)


def test_reference_imports_nothing_of_the_program():
    src = (BENCH / "reference" / "qwen3_asr.py").read_text()
    assert "qwen3_asr_rs_tpu" not in src
