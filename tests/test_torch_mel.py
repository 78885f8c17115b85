"""Port log-mel frontend vs the JAX one (atol 1e-4 on normalized log-mel)."""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.features import mel as jmel
from qwen3_asr_rs_tpu_torch.features import mel as tmel


def test_host_constants_are_the_jax_ones():
    np.testing.assert_array_equal(tmel.create_mel_filterbank(),
                                  jmel.create_mel_filterbank())
    np.testing.assert_array_equal(tmel.hann_window(400), jmel.hann_window(400))
    for a, b in zip(tmel.dft_matrices(400), jmel.dft_matrices(400)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_samples,bucket_frames",
                         [(16000, 100), (23456, 200), (999, 100)])
def test_log_mel_matches_jax(rng, n_samples, bucket_frames):
    samples = (rng.standard_normal(n_samples) * 0.1).astype(np.float32)
    wave, n_true = tmel.pad_waveform(samples, bucket_frames=bucket_frames)
    jwave, jn = jmel.pad_waveform(samples, bucket_frames=bucket_frames)
    np.testing.assert_array_equal(wave, jwave)
    assert n_true == jn

    filters = jmel.create_mel_filterbank()
    ref = np.asarray(jmel.log_mel_from_padded(jnp.asarray(wave), n_true,
                                              jnp.asarray(filters)))
    got = tmel.log_mel_from_padded(torch.from_numpy(wave), n_true,
                                   torch.from_numpy(filters)).numpy()
    assert got.shape == ref.shape == (128, bucket_frames)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # padded frames are exactly zero
    assert np.all(got[:, n_true:] == 0.0)

    ref_max = float(jmel.raw_log_mel_max(jnp.asarray(wave), n_true,
                                         jnp.asarray(filters)))
    got_max = float(tmel.raw_log_mel_max(torch.from_numpy(wave), n_true,
                                         torch.from_numpy(filters)))
    assert abs(got_max - ref_max) < 1e-4


def test_floor_uses_true_frames_only(rng):
    """A loud tail beyond the true frames must not move the max-8 floor."""
    samples = (rng.standard_normal(8000) * 0.01).astype(np.float32)
    wave, n_true = tmel.pad_waveform(samples, bucket_frames=100)
    filters = torch.from_numpy(tmel.create_mel_filterbank())
    base = tmel.log_mel_from_padded(torch.from_numpy(wave), n_true, filters)
    loud = wave.copy()
    loud[-4000:] = 10.0
    got = tmel.log_mel_from_padded(torch.from_numpy(loud), n_true, filters)
    # frames whose window never reaches the loud tail are unchanged
    np.testing.assert_array_equal(got[:, : n_true - 3].numpy(),
                                  base[:, : n_true - 3].numpy())


@pytest.mark.parametrize("lengths,bucket_frames", [
    ((16000, 9000, 999, 15500), 100), ((47000, 16000, 30100), 300)],
    ids=["one-chunk", "three-chunks"])
def test_batched_log_mel_is_each_rows_own(rng, lengths, bucket_frames):
    """A (B, L) batch of padded waves of mixed lengths in one bucket gives
    every row what the 1-D form gives it, each row floored at its own max
    (the second row is 1000x quieter than the others: a batch-wide floor
    would flatten it), frames past its true count exactly 0, and JAX's
    ``vmap`` of its 1-D form."""
    filters = tmel.create_mel_filterbank()
    waves, n_true = [], []
    for i, n in enumerate(lengths):
        amp = 1e-4 if i == 1 else 0.1
        samples = (rng.standard_normal(n) * amp).astype(np.float32)
        wave, nt = tmel.pad_waveform(samples, bucket_frames=bucket_frames)
        waves.append(wave)
        n_true.append(nt)
    waves = np.stack(waves)
    got = tmel.log_mel_from_padded(torch.from_numpy(waves),
                                   torch.tensor(n_true),
                                   torch.from_numpy(filters))
    assert got.dtype == torch.float32
    assert got.shape == (len(lengths), 128, bucket_frames)
    got = got.numpy()
    for row, wave, nt in zip(got, waves, n_true):
        want = tmel.log_mel_from_padded(torch.from_numpy(wave), nt,
                                        torch.from_numpy(filters)).numpy()
        np.testing.assert_allclose(row, want, atol=1e-6, rtol=1e-6)
        assert np.all(row[:, nt:] == 0.0)
    ref = np.asarray(jax.vmap(
        lambda w, n: jmel.log_mel_from_padded(w, n, jnp.asarray(filters)))(
            jnp.asarray(waves), jnp.asarray(n_true)))
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    # the quiet row against a floor at the batch's max
    batch_max = torch.tensor(max(
        float(tmel.raw_log_mel_max(torch.from_numpy(w), nt,
                                   torch.from_numpy(filters)))
        for w, nt in zip(waves, n_true)))
    shared = tmel.log_mel_from_padded(
        torch.from_numpy(waves[1]), n_true[1], torch.from_numpy(filters),
        log_max=batch_max).numpy()
    assert np.abs(shared - got[1]).max() > 0.1
