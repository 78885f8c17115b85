"""Sampling: the port's ``runtime/sampling.py`` against the JAX package's.

The filters give JAX's masks on the same logits and ``filtered_probs``
JAX's probabilities within 1e-6; top-k 1, temperature 0 and a vanishing
top-p are the argmax bit for bit; draws follow ``filtered_probs`` (a chi^2
test), and so does the first token of ``speculative_accept`` (the
speculative-sampling theorem); the extreme random words still draw inside
the filters. The draws themselves are held to JAX's in
``test_torch_prng.py``. Through the engine: the same seed gives the same
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
from qwen3_asr_rs_tpu_torch.ops import prng
from qwen3_asr_rs_tpu_torch.runtime.sampling import (
    SamplingParams,
    apply_top_k,
    apply_top_p,
    filtered_probs,
    normalize,
    sample_token,
    speculative_accept,
)

T = torch.from_numpy
J = jnp.asarray


def _key(seed: int, counter: int):
    """``fold_in(PRNGKey(seed), counter)``."""
    return prng.fold_in(prng.prng_key(seed), counter)


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
        ids = sample_token(logits, _key(5, counter), kw.pop("temperature"),
                           **kw)
        assert torch.equal(ids, greedy)
    # a (V,) row gives a 0-d id
    assert int(sample_token(logits[0], _key(5, counter), 0.0)) == int(
        greedy[0])


@pytest.mark.parametrize("bits", [0, 2**32 - 1])
def test_filtered_tokens_never_drawn_at_extreme_bits(bits, monkeypatch):
    """Every draw at the extreme words still lies inside the filters (JAX's
    uniform maps 0 and all-ones to tiny and 1 - 2^-23, both finite
    Gumbel noise): top-k 1 is the argmax, top-k 5 one of the five
    largest."""
    monkeypatch.setattr(prng, "random_bits", lambda key, shape, offset=0:
                        torch.full(tuple(shape), bits, dtype=torch.int64))
    logits = T(np.random.default_rng(5).standard_normal((4, 300)).astype(
        np.float32))
    assert torch.equal(sample_token(logits, _key(0, 1), 0.7, top_k=1),
                       torch.argmax(logits, -1))
    ids = sample_token(logits, _key(0, 1), 0.7, top_k=5)
    assert (torch.topk(logits, 5).indices == ids[:, None]).any(-1).all()


@pytest.mark.parametrize("k", [1, 2])
def test_top_k_keeps_ties_as_jax(k):
    """A logit tied with the k-th is kept, as JAX's mask keeps it, so top-k
    1 draws among tied largest logits (greedy takes the lowest index)."""
    logits = np.array([[0.5, 2.0, -1.0, 2.0, 1.0, 2.0]], np.float32)
    got = apply_top_k(T(logits), k).numpy()
    want = np.asarray(jsampling.apply_top_k(J(logits), k))
    np.testing.assert_array_equal(got, want)
    drawn = {int(sample_token(T(logits), _key(9, c), 1.0, top_k=k)[0])
             for c in range(64)}
    assert drawn == {1, 3, 5}


def test_sampled_ids_respect_filters(rng):
    logits = T(rng.standard_normal((8, 64)).astype(np.float32))
    top5 = torch.topk(logits, 5).indices
    for counter in range(20):
        ids = sample_token(logits, _key(3, counter), 5.0, top_k=5)
        assert (top5 == ids[:, None]).any(-1).all()


def test_per_row_temperature_vector(rng):
    logits = T(rng.standard_normal((4, 512)).astype(np.float32))
    temp = torch.tensor([0.0, 0.0, 8.0, 8.0])
    greedy = torch.argmax(logits, -1)
    differ = False
    for counter in range(16):
        ids = sample_token(logits, _key(0, counter), temp)
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
        ids = sample_token(rows, _key(11, counter), temp, top_k=k, top_p=p)
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
        drafts = torch.stack([sample_token(torch.log(q[j]),
                                           _key(1000 + j, i), 1.0)
                              for j in range(2)])
        acc, nxt = speculative_accept(_key(7, i), drafts, q, p)
        counts[int(drafts[0]) if int(acc) >= 1 else int(nxt)] += 1
    assert _chi2_pvalue(counts, p[0].double().numpy()) > 1e-3


def test_speculative_accept_edge_cases():
    p = torch.tensor([[0.3, 0.3, 0.2, 0.2], [0.1, 0.2, 0.3, 0.4],
                      [0.25, 0.25, 0.25, 0.25]])
    for i in range(64):
        drafts = torch.tensor([i % 4, (i // 4) % 4])
        acc, _ = speculative_accept(_key(0, i), drafts, p[:2], p)
        assert int(acc) == 2  # q == p: every draft accepted
    # a one-hot draft on a token the target gives no mass: always
    # rejected at position 0, the resample follows p[0]
    q0 = torch.tensor([[1.0, 0.0, 0.0, 0.0], [0.25, 0.25, 0.25, 0.25]])
    p0 = torch.tensor([[0.0, 0.5, 0.3, 0.2], [0.1, 0.2, 0.3, 0.4],
                       [0.25, 0.25, 0.25, 0.25]])
    counts = np.zeros(4)
    for i in range(3000):
        acc, nxt = speculative_accept(_key(1, i), torch.tensor([0, 0]), q0,
                                      p0)
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
