"""Sampling: the port's ``runtime/sampling.py`` against the JAX package's.

The filters give JAX's masks on the same logits and ``filtered_probs``
JAX's probabilities within 1e-6; top-k 1, temperature 0 and a vanishing
top-p are the argmax bit for bit; draws follow ``filtered_probs`` (a chi^2
test), and so does the first token of ``speculative_accept`` (the
speculative-sampling theorem); the counter-based hash is a pure function
of (seed, counter, stream, row, column), equal to a plain-integer
transcription of it. Through the engine: the same seed gives the same
tokens, another seed others, pad rows emit nothing and long-form audio
with sampling raises JAX's error.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats import chi2

from qwen3_asr_rs_tpu.runtime import sampling as jsampling
from qwen3_asr_rs_tpu_torch.runtime.sampling import (
    SamplingParams,
    apply_top_k,
    apply_top_p,
    draw_bits,
    filtered_probs,
    normalize,
    sample_token,
    speculative_accept,
    uniforms,
    unit_from_bits,
)

T = torch.from_numpy
J = jnp.asarray


def _finite(x):
    return np.isfinite(np.asarray(x))


@pytest.mark.parametrize("k", [1, 5, 31, 64, 100])
def test_top_k_mask_matches_jax(rng, k):
    logits = rng.standard_normal((4, 64)).astype(np.float32)
    got = apply_top_k(T(logits), k)
    np.testing.assert_array_equal(_finite(got),
                                  _finite(jsampling.apply_top_k(J(logits), k)))
    assert (_finite(got).sum(-1) == min(k, 64)).all()


@pytest.mark.parametrize("p", [1e-9, 0.1, 0.5, 0.8, 0.95, 1.0])
def test_top_p_mask_matches_jax(rng, p):
    logits = (rng.standard_normal((4, 128)) * 2).astype(np.float32)
    np.testing.assert_array_equal(
        _finite(apply_top_p(T(logits), p)),
        _finite(jsampling.apply_top_p(J(logits), p)))
    # a per-row (B,) tensor, as JAX's traced top_p
    rows = np.asarray([0.2, 0.5, 1.0, p], np.float32)
    np.testing.assert_array_equal(
        _finite(apply_top_p(T(logits), T(rows))),
        _finite(jsampling.apply_top_p(J(logits), J(rows))))


def test_top_p_keeps_minimal_nucleus():
    logits = torch.log(torch.tensor([[0.6, 0.3, 0.06, 0.03, 0.01]]))
    kept = torch.isfinite(apply_top_p(logits, 0.8))[0].tolist()
    assert kept == [True, True, False, False, False]
    kept1 = torch.isfinite(apply_top_p(logits, 0.1))[0].tolist()
    assert kept1 == [True, False, False, False, False]


@pytest.mark.parametrize("temp,k,p", [(1.0, 0, 1.0), (0.7, 8, 1.0),
                                      (1.3, 0, 0.7), (0.9, 8, 0.7),
                                      (2.5, 1, 1.0)])
def test_filtered_probs_match_jax(rng, temp, k, p):
    logits = (rng.standard_normal((3, 64)) * 2).astype(np.float32)
    got = filtered_probs(T(logits), temp, top_k=k, top_p=p).numpy()
    want = np.asarray(jsampling.filtered_probs(J(logits), temp, k, p))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    # the support is exactly the filtered support
    np.testing.assert_array_equal(got > 0, want > 0)


@pytest.mark.parametrize("counter", [0, 1, 7])
def test_greedy_limits_are_the_argmax_bit_for_bit(rng, counter):
    logits = T(rng.standard_normal((3, 128)).astype(np.float32))
    greedy = torch.argmax(logits, -1)
    for kw in (dict(temperature=0.0), dict(temperature=2.5, top_k=1),
               dict(temperature=3.0, top_p=1e-9)):
        ids = sample_token(logits, 5, counter, kw.pop("temperature"), **kw)
        assert torch.equal(ids, greedy)
    # a (V,) row gives a 0-d id
    assert int(sample_token(logits[0], 5, counter, 0.0)) == int(greedy[0])


@pytest.mark.parametrize("bits", [0, 2**32 - 1])
def test_filtered_tokens_never_drawn_at_extreme_bits(bits, monkeypatch):
    """Every draw at the extreme bits still lies inside the filters: top-k
    1 is the argmax, top-k 5 one of the five largest."""
    from qwen3_asr_rs_tpu_torch.runtime import sampling

    monkeypatch.setattr(sampling, "draw_bits", lambda seed, counter, rows,
                        cols, device, stream, row0: torch.full(
                            (rows, cols), bits, dtype=torch.int64))
    logits = T(np.random.default_rng(5).standard_normal((4, 300)).astype(
        np.float32))
    assert torch.equal(sample_token(logits, 0, 1, 0.7, top_k=1),
                       torch.argmax(logits, -1))
    ids = sample_token(logits, 0, 1, 0.7, top_k=5)
    assert (torch.topk(logits, 5).indices == ids[:, None]).any(-1).all()


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_keeps_ties_as_jax(k):
    """A logit tied with the k-th is kept, as JAX's mask keeps it, so top-k
    1 draws among tied largest logits (greedy takes the lowest index)."""
    logits = np.array([[0.5, 2.0, -1.0, 2.0, 1.0, 2.0]], np.float32)
    got = apply_top_k(T(logits), k).numpy()
    want = np.asarray(jsampling.apply_top_k(J(logits), k))
    np.testing.assert_array_equal(got, want)
    drawn = {int(sample_token(T(logits), 9, c, 1.0, top_k=k)[0])
             for c in range(64)}
    assert drawn == {1, 3, 5}


def test_sampled_ids_respect_filters(rng):
    logits = T(rng.standard_normal((8, 64)).astype(np.float32))
    top5 = torch.topk(logits, 5).indices
    for counter in range(20):
        ids = sample_token(logits, 3, counter, 5.0, top_k=5)
        assert (top5 == ids[:, None]).any(-1).all()


def test_deterministic_per_key_stochastic_across_keys(rng):
    logits = T(rng.standard_normal((4, 256)).astype(np.float32))
    a = sample_token(logits, 3, 1, 1.0)
    assert torch.equal(a, sample_token(logits, 3, 1, 1.0))
    draws = {tuple(sample_token(logits, s, 1, 2.0).tolist())
             for s in range(16)}
    assert len(draws) > 1
    draws = {tuple(sample_token(logits, 3, c, 2.0).tolist())
             for c in range(16)}
    assert len(draws) > 1


def test_per_row_temperature_vector(rng):
    logits = T(rng.standard_normal((4, 512)).astype(np.float32))
    temp = torch.tensor([0.0, 0.0, 8.0, 8.0])
    greedy = torch.argmax(logits, -1)
    differ = False
    for counter in range(16):
        ids = sample_token(logits, 0, counter, temp)
        assert torch.equal(ids[:2], greedy[:2])
        differ |= bool((ids[2:] != greedy[2:]).any())
    assert differ


def _chi2_pvalue(counts, probs):
    n = counts.sum()
    keep = probs > 0
    assert counts[~keep].sum() == 0, "a draw outside the support"
    exp = probs[keep] * n
    stat = (((counts[keep] - exp) ** 2) / exp).sum()
    return chi2.sf(stat, keep.sum() - 1)


@pytest.mark.parametrize("temp,k,p", [(1.0, 0, 1.0), (0.8, 4, 1.0),
                                      (1.5, 0, 0.8)])
def test_sample_token_follows_filtered_probs(temp, k, p):
    """8000 draws (400 counters x 20 rows of the same logits) against
    filtered_probs: chi^2 p-value above 1e-3."""
    logits = torch.log(torch.tensor([0.3, 0.25, 0.15, 0.12, 0.1, 0.05,
                                     0.03]))
    rows = logits.expand(20, -1)
    counts = np.zeros(7)
    for counter in range(400):
        ids = sample_token(rows, 11, counter, temp, top_k=k, top_p=p)
        counts += np.bincount(ids.numpy(), minlength=7)
    probs = filtered_probs(logits, temp, top_k=k, top_p=p).numpy()
    assert _chi2_pvalue(counts, probs.astype(np.float64)) > 1e-3


def test_speculative_accept_first_token_distribution():
    """With drafts drawn from an adversarial q, the first emitted token
    (the accepted d_1 or the resample) follows the target p_1."""
    q = torch.tensor([[0.7, 0.1, 0.1, 0.1], [0.25, 0.25, 0.25, 0.25]])
    p = torch.tensor([[0.1, 0.6, 0.2, 0.1], [0.05, 0.05, 0.8, 0.1],
                      [0.4, 0.3, 0.2, 0.1]])
    counts = np.zeros(4)
    n = 4000
    for i in range(n):
        drafts = torch.stack([sample_token(torch.log(q[j]), 1000 + j, i, 1.0)
                              for j in range(2)])
        acc, nxt = speculative_accept(7, i, drafts, q, p)
        counts[int(drafts[0]) if int(acc) >= 1 else int(nxt)] += 1
    assert _chi2_pvalue(counts, p[0].double().numpy()) > 1e-3


def test_speculative_accept_edge_cases():
    p = torch.tensor([[0.3, 0.3, 0.2, 0.2], [0.1, 0.2, 0.3, 0.4],
                      [0.25, 0.25, 0.25, 0.25]])
    for i in range(64):
        drafts = torch.tensor([i % 4, (i // 4) % 4])
        acc, _ = speculative_accept(0, i, drafts, p[:2], p)
        assert int(acc) == 2  # q == p: every draft accepted
    # a one-hot draft on a token the target gives no mass: always
    # rejected at position 0, the resample follows p[0]
    q0 = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]])
    p0 = torch.tensor([[0.0, 0.5, 0.3, 0.2], [0.1, 0.2, 0.3, 0.4],
                       [0.25, 0.25, 0.25, 0.25]])
    counts = np.zeros(4)
    for i in range(3000):
        acc, nxt = speculative_accept(1, i, torch.tensor([0, 0]), q0, p0)
        assert int(acc) == 0
        counts[int(nxt)] += 1
    assert _chi2_pvalue(counts, p0[0].double().numpy()) > 1e-3


def test_params_validation_messages_match_jax():
    for kw in (dict(top_p=0.0), dict(top_p=1.5), dict(top_k=-1),
               dict(temperature=-0.5)):
        with pytest.raises(ValueError) as got:
            SamplingParams(**kw).validate()
        with pytest.raises(ValueError) as want:
            jsampling.SamplingParams(**kw).validate()
        assert str(got.value) == str(want.value)
    assert normalize(None).greedy
    assert not normalize(SamplingParams(temperature=0.9)).greedy


# ---- the counter-based hash ----------------------------------------------

M32 = 0xFFFFFFFF


def _mix32_int(x):
    x ^= x >> 16
    x = (x * 0x7FEB352D) & M32
    x ^= x >> 15
    x = (x * 0x846CA68B) & M32
    return x ^ (x >> 16)


def _draw_bits_int(seed, counter, row, col, stream=0):
    """``draw_bits`` in plain Python integers (unbounded, no wrap)."""
    k = _mix32_int((seed & M32) ^ _mix32_int((seed >> 32) & M32))
    k = _mix32_int(k ^ _mix32_int(counter & M32))
    k = _mix32_int(k ^ stream)
    k = _mix32_int(k ^ _mix32_int(row))
    return _mix32_int(k ^ col)


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 + 7, 2**40 + 3, -5])
def test_draw_bits_equal_integer_transcription(seed):
    got = draw_bits(seed, 9, 3, 50).tolist()
    for r in range(3):
        assert got[r] == [_draw_bits_int(seed, 9, r, c) for c in range(50)]
    assert draw_bits(seed, 9, 2, 4, stream=1).tolist()[1][3] == (
        _draw_bits_int(seed, 9, 1, 3, stream=1))
    # tensor arguments (the engine's device state) give the same bits
    assert torch.equal(draw_bits(torch.tensor(seed), torch.tensor(9), 3, 50),
                       draw_bits(seed, 9, 3, 50))


def test_uniforms_in_open_interval_and_flat():
    u = uniforms(0, 0, 64, 4096)
    assert 0 < float(u.min()) and float(u.max()) < 1
    # the extreme bits too: finite Gumbel noise at both ends
    ends = unit_from_bits(torch.tensor([0, 2**32 - 1], dtype=torch.int64))
    assert 0 < float(ends[0]) and float(ends[1]) < 1
    assert torch.isfinite(torch.log(-torch.log(ends))).all()
    hist = np.histogram(u.numpy(), bins=16, range=(0, 1))[0]
    assert _chi2_pvalue(hist.astype(float), np.full(16, 1 / 16)) > 1e-3


# ---- through the engine --------------------------------------------------


def _engine(max_new=6, buckets=(1, 2)):
    from test_torch_engine import _engines, _tiny

    return _engines(_tiny, jnp.float32, torch.float32, max_new, buckets)


CLIPS = [(np.random.default_rng(30 + i).standard_normal(n) * 0.1).astype(
    np.float32) for i, n in enumerate((16000, 12000, 9000))]


def test_engine_sampling_same_seed_same_tokens():
    _, teng = _engine()
    sp = SamplingParams(temperature=1.5, top_k=50, top_p=0.9, seed=0)
    for batch in ([CLIPS[0]], CLIPS):
        a = [r.raw_output for r in teng.transcribe_batch(batch, sampling=sp)]
        b = [r.raw_output for r in teng.transcribe_batch(batch, sampling=sp)]
        c = [r.raw_output for r in teng.transcribe_batch(
            batch, sampling=SamplingParams(temperature=1.5, top_k=50,
                                           top_p=0.9, seed=1))]
        assert a == b and a != c
    greedy = [r.raw_output for r in teng.transcribe_batch(CLIPS)]
    for sp in (SamplingParams(temperature=0.0, seed=4),
               SamplingParams(temperature=2.0, top_k=1, seed=4)):
        assert [r.raw_output for r in teng.transcribe_batch(
            CLIPS, sampling=sp)] == greedy


def test_engine_sampling_pad_rows_emit_nothing():
    _, teng = _engine()
    out = teng.transcribe_batch(CLIPS, sampling=SamplingParams(
        temperature=1.0, seed=3))
    assert len(out) == 3 and teng.last_stats["n_gen"][3] == 0
    assert all(n == 6 for n in teng.last_stats["n_gen"][:3])


def test_engine_longform_sampling_raises_jax_error(tmp_path):
    from test_audio_io import write_wav_pcm16

    jeng, teng = _engine()
    wav = tmp_path / "long.wav"
    write_wav_pcm16(wav, np.random.default_rng(4).standard_normal(16000 * 5)
                    * 0.1, 16000)
    with pytest.raises(ValueError) as got:
        teng.transcribe(wav, sampling=SamplingParams(temperature=0.5))
    with pytest.raises(ValueError) as want:
        jeng.transcribe(str(wav), sampling=jsampling.SamplingParams(
            temperature=0.5))
    assert str(got.value) == str(want.value)
    assert "long-form" in str(got.value)
