"""The port's import surface: every name in a JAX subpackage's
``__all__`` imports from the port's counterpart."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import importlib

import pytest

SUBPACKAGES = ["", ".audio", ".features", ".models", ".ops", ".parallel",
               ".runtime", ".training", ".utils", ".weights"]


@pytest.mark.parametrize("sub", SUBPACKAGES)
def test_every_jax_export_imports_from_the_port(sub):
    jax_pkg = importlib.import_module(f"qwen3_asr_rs_tpu{sub}")
    port = importlib.import_module(f"qwen3_asr_rs_tpu_torch{sub}")
    missing = [n for n in jax_pkg.__all__ if not hasattr(port, n)]
    assert not missing, f"qwen3_asr_rs_tpu_torch{sub} lacks {missing}"
    assert set(jax_pkg.__all__) <= set(port.__all__)


def test_models_import_the_decoder_and_the_initialisers():
    from qwen3_asr_rs_tpu_torch.models import (  # noqa: F401
        AudioEncoder,
        TextDecoder,
        init_decoder_params,
        init_encoder_params,
    )
    from qwen3_asr_rs_tpu_torch.models.audio_encoder import (
        conv_stem_output_time,
    )
    from qwen3_asr_rs_tpu.models.audio_encoder import (
        conv_stem_output_time as jax_conv_stem_output_time,
    )

    for frames in (1, 7, 100, 101):
        assert conv_stem_output_time(frames) == jax_conv_stem_output_time(
            frames)


def test_log_mel_frontend_matches_jax(rng):
    """``LogMelFrontend`` at the exact frame count and at a bucket (atol
    1e-4, the port's mel tolerance)."""
    import numpy as np

    from qwen3_asr_rs_tpu.features import LogMelFrontend as JFrontend
    from qwen3_asr_rs_tpu_torch.features import LogMelFrontend

    samples = (rng.standard_normal(5000) * 0.1).astype(np.float32)
    port, jax_fe = LogMelFrontend(device="cpu"), JFrontend()
    for bucket in (None, 100):
        got, n = port(samples, bucket)
        want, jn = jax_fe(samples, bucket)
        assert n == jn == 32
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
