"""JAX's threefry stream in the port (``ops/prng.py``) against ``jax.random``.

Keys, ``fold_in``, ``split``, 32-bit ``bits`` and ``uniform`` are held bit
for bit to JAX 0.9.0's (threefry2x32, partitionable bits) over seeds,
counters and shapes drawn by hypothesis, one full 151,936-wide row
included; ``gumbel`` within GUMBEL_ULPS units in the last place of
max(1, |g|) (both sides take two float32 logs, whose last bits differ);
``categorical``, ``sample_token`` (every filter, per-row temperature and
top_p vectors) and ``speculative_accept`` give JAX's tokens, except where
the two best values of logit + noise lie within TIE of each other, which
is counted and must not happen on these inputs. The draw's plain
version is also held to its own definition: a ``KeyChain`` resolves to
its fold_ins, ``then_split`` to JAX's ``split``, and ``row_offset`` draws
a block of rows as those rows of the whole array.

The float checks run with one torch thread: on this CPU build torch's
multithreaded ``log`` was seen to return one thread's chunk with errors
near 1e-4 in a fresh process, now and then.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from qwen3_asr_rs_tpu.runtime import sampling as jsampling
from qwen3_asr_rs_tpu_torch.ops import prng
from qwen3_asr_rs_tpu_torch.ops.kernels.gumbel_argmax import (
    gumbel_argmax,
    threefry_noise,
)
from qwen3_asr_rs_tpu_torch.runtime import sampling as tsampling
from qwen3_asr_rs_tpu_torch.weights.convert import key_to_torch

V = 151936
# gumbel: |port - JAX| <= GUMBEL_ULPS * 2^-23 * max(1, |g|)
GUMBEL_ULPS = 4
# tokens may differ only where the top two of logit + noise lie within
# TIE * max(1, |best|) of each other
TIE = 1e-5
SETTINGS = settings(max_examples=20, deadline=None,
                    suppress_health_check=[HealthCheck.too_slow])
SEEDS = st.integers(-(1 << 63), (1 << 63) - 1)
WORDS = st.integers(0, (1 << 32) - 1)
SHAPES = st.sampled_from([(1,), (7,), (2, 3), (3, 5, 4), (1, 1000),
                          (5, 513)])


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _same(tkey, jkey):
    assert tkey.tolist() == np.asarray(jkey).astype(np.int64).tolist()


def _ties(values):
    """Rows whose best two values lie within TIE of each other."""
    top = torch.topk(torch.as_tensor(values).reshape(-1, values.shape[-1]),
                     2, dim=-1).values
    return (top[:, 0] - top[:, 1]) <= TIE * top[:, 0].abs().clamp(min=1)


# ---- keys ------------------------------------------------------------


@SETTINGS
@given(seed=SEEDS)
def test_prng_key_matches_jax(seed):
    _same(prng.prng_key(seed), _jkey(seed))


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31, 2**32 + 3, 2**40 + 5, -1,
                                  -2**31, -2**63, 2**63 - 1, np.int64(5),
                                  np.uint32(9), True])
def test_prng_key_edge_seeds(seed):
    _same(prng.prng_key(seed), _jkey(seed))


@pytest.mark.parametrize("seed,error", [(2**63, OverflowError),
                                        (-2**63 - 1, OverflowError),
                                        (2**64, OverflowError),
                                        (1.0, TypeError),
                                        (np.float32(2), TypeError),
                                        (np.array([1, 2]), TypeError)])
def test_prng_key_raises_as_jax(seed, error):
    with pytest.raises(error):
        _jkey(seed)
    with pytest.raises(error):
        prng.prng_key(seed)


@SETTINGS
@given(seed=SEEDS, data=WORDS)
def test_fold_in_matches_jax(seed, data):
    got = prng.fold_in(prng.prng_key(seed), data)
    _same(got, jax.random.fold_in(_jkey(seed), data))
    # a device counter (0-d tensor) folds in the same word
    _same(prng.fold_in(prng.prng_key(seed), torch.tensor(data)),
          jax.random.fold_in(_jkey(seed), data))


@pytest.mark.parametrize("data", [-1, 2**32])
def test_fold_in_raises_as_jax(data):
    with pytest.raises(OverflowError):
        jax.random.fold_in(_jkey(0), data)
    with pytest.raises(OverflowError):
        prng.fold_in(prng.prng_key(0), data)


@SETTINGS
@given(seed=SEEDS, num=st.integers(1, 6))
def test_split_matches_jax(seed, num):
    got = prng.split(prng.prng_key(seed), num)
    _same(got, jax.random.split(_jkey(seed), num))
    for i in range(num):  # split(key)[i] == fold_in(key, i)
        assert torch.equal(got[i], prng.fold_in(prng.prng_key(seed), i))


def test_key_data_carries_across():
    """A JAX key's data as the port's key tensor: the same draws."""
    jk = jax.random.fold_in(_jkey(3), 11)
    tk = key_to_torch(jax.random.key_data(jk))
    assert torch.equal(tk, prng.fold_in(prng.prng_key(3), 11))
    assert torch.equal(key_to_torch(np.stack([np.asarray(jk)] * 2)),
                       torch.stack([tk, tk]))
    with pytest.raises(ValueError):
        key_to_torch(np.zeros(2, np.int32))


# ---- bits, uniforms, Gumbel noise ------------------------------------


@SETTINGS
@given(seed=SEEDS, data=WORDS, shape=SHAPES)
def test_random_bits_match_jax(seed, data, shape):
    jk = jax.random.fold_in(_jkey(seed), data)
    tk = prng.fold_in(prng.prng_key(seed), data)
    want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
    assert np.array_equal(prng.random_bits(tk, shape).numpy(),
                          want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 123456789, -7])
def test_full_vocab_row_matches_jax(seed):
    """One 151,936-wide row: bits and uniforms bit-equal, Gumbel noise
    within GUMBEL_ULPS, the draw equal."""
    jk, tk = _jkey(seed), prng.prng_key(seed)
    want = np.asarray(jax.random.bits(jk, (V,), jnp.uint32))
    assert np.array_equal(prng.random_bits(tk, (V,)).numpy(),
                          want.astype(np.int64))
    tiny = np.finfo(np.float32).tiny
    u = np.asarray(jax.random.uniform(jk, (V,), minval=tiny))
    assert np.array_equal(prng.uniform(tk, (V,), minval=prng.FLOAT32_TINY)
                          .numpy().view(np.int32), u.view(np.int32))
    _gumbel_close(prng.gumbel(tk, (V,)), jax.random.gumbel(jk, (V,)))
    logits = (np.random.default_rng(seed & 0xFFFF).standard_normal(V)
              * 2).astype(np.float32)
    assert int(prng.categorical(tk, torch.from_numpy(logits))) == int(
        jax.random.categorical(jk, jnp.asarray(logits)))


@SETTINGS
@given(seed=SEEDS, shape=SHAPES,
       bounds=st.sampled_from([(0.0, 1.0), ("tiny", 1.0), (-2.5, 3.0),
                               (0.25, 0.5)]))
def test_uniform_matches_jax(seed, shape, bounds):
    lo, hi = bounds
    if lo == "tiny":
        lo = float(np.finfo(np.float32).tiny)
    want = np.asarray(jax.random.uniform(_jkey(seed), shape, minval=lo,
                                         maxval=hi))
    got = prng.uniform(prng.prng_key(seed), shape, lo, hi).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _gumbel_close(got, want):
    want = np.asarray(want).astype(np.float64)
    err = np.abs(got.numpy().astype(np.float64) - want)
    assert (err <= GUMBEL_ULPS * 2.0**-23 * np.maximum(1, np.abs(want))).all()
    assert np.isfinite(got.numpy()).all()


@SETTINGS
@given(seed=SEEDS, shape=SHAPES)
def test_gumbel_within_ulps_of_jax(seed, shape):
    _gumbel_close(prng.gumbel(prng.prng_key(seed), shape),
                  jax.random.gumbel(_jkey(seed), shape))


def test_extreme_bits_give_finite_noise():
    """Words 0 and all-ones: u = tiny and 1 - 2^-23, finite Gumbel noise
    at both ends (JAX's)."""
    bits = torch.tensor([0, 2**32 - 1], dtype=torch.int64)
    u = prng.uniform_from_bits(bits, prng.FLOAT32_TINY, 1.0)
    assert u.tolist() == [prng.FLOAT32_TINY, 1 - 2.0**-23]
    g = prng.gumbel_from_bits(bits)
    assert torch.isfinite(g).all() and g[0] < g[1]


@SETTINGS
@given(seed=SEEDS, rows=st.integers(1, 4), lo=st.integers(0, 5))
def test_offset_draws_rows_of_the_whole_array(seed, rows, lo):
    """A block of rows drawn at its offset equals those rows of the whole
    (lo + rows + 2, 300) draw; a row-index tensor picks any rows."""
    key = prng.prng_key(seed)
    whole = prng.random_bits(key, (lo + rows + 2, 300))
    assert torch.equal(prng.random_bits(key, (rows, 300), lo * 300),
                       whole[lo:lo + rows])
    idx = torch.tensor([lo + rows + 1] + list(range(rows - 1)))
    assert torch.equal(threefry_noise(key, (rows, 300), "bits", idx,
                                      device="cpu"), whole[idx])
    x = torch.from_numpy(np.random.default_rng(lo).standard_normal(
        (lo + rows + 2, 300)).astype(np.float32))
    assert torch.equal(prng.categorical(key, x[lo:lo + rows], lo),
                       prng.categorical(key, x)[lo:lo + rows])
    assert torch.equal(gumbel_argmax(x[idx], key, idx),
                       prng.categorical(key, x)[idx])


# ---- key chains ------------------------------------------------------


def test_key_chain_resolves_to_its_fold_ins():
    base = prng.prng_key(42)
    step = torch.tensor(6)
    chain = prng.KeyChain(base, ((step, 1), 2, step))
    want = prng.fold_in(prng.fold_in(prng.fold_in(base, 7), 2), 6)
    assert torch.equal(chain.resolve(), want)
    x = torch.randn(3, 500)
    assert torch.equal(gumbel_argmax(x, chain), prng.categorical(want, x))
    with pytest.raises(ValueError):
        prng.KeyChain(base, (1,), then_split=True)
    with pytest.raises(ValueError):
        prng.KeyChain(base, (1, 2, 3, 4, 5))


def test_then_split_is_jax_split():
    """A split chain draws with JAX's ``sub`` of ``key, sub = split(key)``
    and leaves ``key`` in the base tensor, draw after draw."""
    x = np.random.default_rng(1).standard_normal((4, 700)).astype(np.float32)
    base = prng.prng_key(9)
    jkey = _jkey(9)
    for _ in range(3):
        jkey, sub = jax.random.split(jkey)
        want = np.asarray(jax.random.categorical(sub, jnp.asarray(x)))
        got = gumbel_argmax(torch.from_numpy(x),
                            prng.KeyChain(base, then_split=True))
        assert got.tolist() == want.tolist()
        _same(base, jkey)


# ---- draws -----------------------------------------------------------


@SETTINGS
@given(seed=SEEDS, data=WORDS, shape=st.sampled_from([(3, 1000), (2000,),
                                                      (1, V)]))
def test_categorical_matches_jax(seed, data, shape):
    rng = np.random.default_rng(data)
    logits = (rng.standard_normal(shape) * 3).astype(np.float32)
    logits[..., rng.integers(0, shape[-1], 20)] = -np.inf
    jk = jax.random.fold_in(_jkey(seed), data)
    tk = prng.fold_in(prng.prng_key(seed), data)
    want = np.asarray(jax.random.categorical(jk, jnp.asarray(logits)))
    got = prng.categorical(tk, torch.from_numpy(logits)).numpy()
    noisy = prng.gumbel(tk, shape) + torch.from_numpy(logits)
    differ = got != want
    assert not differ.any() or _ties(noisy)[np.reshape(differ, -1)].all()
    assert not _ties(noisy).any()  # no near-tie on these inputs


FILTERS = [(0, 1.0), (1, 1.0), (50, 1.0), (0, 0.9), (20, 0.8), (0, 1e-6)]


@pytest.mark.parametrize("top_k,top_p", FILTERS)
@pytest.mark.parametrize("seed", [0, 1, 2**40 + 3])
def test_sample_token_matches_jax(rng, seed, top_k, top_p):
    """sample_token over every filter with a per-row temperature vector
    (a greedy row among them), then a per-row top_p vector: JAX's tokens
    at ``fold_in(PRNGKey(seed), step)`` for several steps."""
    logits = (rng.standard_normal((5, 4000)) * 2).astype(np.float32)
    temp = np.array([0.7, 0.0, 1.0, 1.3, 0.9], np.float32)
    topp = np.array([0.5, 1.0, 0.9, 0.95, 1.0], np.float32)
    base = prng.prng_key(seed)
    for step in (0, 1, 17):
        jk = jax.random.fold_in(_jkey(seed), step)
        want = np.asarray(jsampling.sample_token(
            jnp.asarray(logits), jk, jnp.asarray(temp), top_k, top_p))
        got = tsampling.sample_token(
            torch.from_numpy(logits), prng.KeyChain(base, (step,)),
            torch.from_numpy(temp), top_k, top_p)
        assert got.tolist() == want.tolist()
        assert int(got[1]) == int(np.argmax(logits[1]))  # temperature 0
        want = np.asarray(jsampling.sample_token(
            jnp.asarray(logits), jk, 0.8, top_k, jnp.asarray(topp)))
        got = tsampling.sample_token(
            torch.from_numpy(logits), prng.fold_in(base, step), 0.8, top_k,
            torch.from_numpy(topp))
        assert got.tolist() == want.tolist()
    # a (V,) row: a 0-d id, JAX's
    want = jsampling.sample_token(jnp.asarray(logits[0]), _jkey(seed), 0.7,
                                  top_k, top_p)
    got = tsampling.sample_token(torch.from_numpy(logits[0]), base, 0.7,
                                 top_k, top_p)
    assert got.ndim == 0 and int(got) == int(want)


@SETTINGS
@given(seed=SEEDS, k=st.integers(1, 4), data=WORDS)
def test_speculative_accept_matches_jax(seed, k, data):
    """(acc, token) equal to JAX's: the acceptance uniforms at
    ``fold_in(key, 0)``, the replacement or bonus draw at ``fold_in(key,
    1)``; drafts half from q, half arbitrary, so that both paths run."""
    rng = np.random.default_rng(data)
    v = 64
    q = rng.dirichlet(np.full(v, 0.3), size=k).astype(np.float32)
    p = rng.dirichlet(np.full(v, 0.3), size=k + 1).astype(np.float32)
    drafts = np.array([rng.choice(v, p=q[i] / q[i].sum()) if i % 2 == 0
                       else rng.integers(0, v) for i in range(k)], np.int32)
    jk = jax.random.fold_in(_jkey(seed), data)
    ja, jt = jsampling.speculative_accept(jk, jnp.asarray(drafts),
                                          jnp.asarray(q), jnp.asarray(p))
    base = prng.prng_key(seed)
    ta, tt = tsampling.speculative_accept(
        prng.KeyChain(base, (data,)), torch.from_numpy(drafts).long(),
        torch.from_numpy(q), torch.from_numpy(p))
    assert (int(ta), int(tt)) == (int(ja), int(jt))
