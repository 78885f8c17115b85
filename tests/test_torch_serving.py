"""Serving in the port: per-row decode positions, the batched and chunked
prefills, per-row sampling keys and the ContinuousBatcher's scheduling,
held against the JAX package (float32, CPU).

The decoder entries are compared with the JAX decoder's on the same
inputs (logits and slabs within 1e-5; int8 slab values within one
quantization step, since a float32 ulp of a fresh K/V can flip one
rounding). The scheduler cases port ``tests/test_serving.py``'s: a
request's raw output through the batcher must equal, exactly, the JAX
engine's ``transcribe_samples`` and the port engine's on the same
weights (``tiny_test_config()`` with the full vocabulary and decoder
weights drawn at scale 0.3, so that tokens vary from step to step and
clip to clip). The admission paths are in
``test_torch_serving_admission.py``, the HTTP server in
``test_torch_server.py``.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import functools
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models.text_decoder import (
    KVCache,
    TextDecoder,
    quantize_kv,
)
from qwen3_asr_rs_tpu_torch.runtime import sampling
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.runtime.serving import (
    ContinuousBatcher,
    Request,
    ServingLoop,
)

from test_torch_engine import _Tok, _tiny
from test_torch_models import _decoders

T = torch.from_numpy
TOL = dict(atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------
# engines and helpers shared with the other serving test files


class Pair:
    """The JAX engine and the port engine on the same weights, with the
    offline raw output of each clip (both engines' must be equal)."""

    def __init__(self, jeng, teng):
        self.jax, self.port = jeng, teng
        self._offline = {}

    def offline(self, clip) -> str:
        key = clip.tobytes()
        if key not in self._offline:
            want = self.jax.transcribe_samples(clip).raw_output
            assert self.port.transcribe_samples(clip).raw_output == want
            self._offline[key] = want
        return self._offline[key]


@functools.lru_cache(maxsize=None)
def engines(max_new: int = 4, buckets=(2, 4, 8), kv_dtype=None) -> Pair:
    """A Pair on ``tiny_test_config()`` (full vocabulary), float32."""
    cfg, tcfg = _tiny(jconfig), _tiny(tconfig)
    enc = init_encoder_params(cfg.audio, dtype=jnp.float32)
    dec = init_decoder_params(cfg.text, dtype=jnp.float32, scale=0.3)
    kw = dict(dtype=jnp.float32, max_new_tokens=max_new,
              chunk_buckets=buckets, params=(enc, dec), tokenizer=_Tok(),
              kv_dtype=kv_dtype)
    return Pair(JaxEngine(model_dir=None, config=cfg, **kw),
                AsrEngine(None, **dict(kw, dtype=torch.float32),
                          config=tcfg, device="cpu"))


def clip(seed: int, n: int) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(n) * 0.1).astype(
        np.float32)


def drive(batcher, until, max_iters=300):
    for _ in range(max_iters):
        if until():
            return
        batcher.step(block_timeout=0.001)
    raise AssertionError("batcher did not converge")


def run_all(batcher, reqs):
    for r in reqs:
        batcher.submit(r)
    drive(batcher, lambda: all(r.event.is_set() for r in reqs))
    for r in reqs:
        if r.error is not None:
            raise r.error
    return [r.result.raw_output for r in reqs]


# ---------------------------------------------------------------------
# decoder entries against JAX's


def _slabs(rng, cfg, b, s, quantized):
    """(JAX cache, port cache) holding the same random slab."""
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, s,
             cfg.head_dim)
    k, v = (T((rng.standard_normal(shape) * 0.5).astype(np.float32))
            for _ in range(2))
    if not quantized:
        return (JCache(k=jnp.asarray(k.numpy()), v=jnp.asarray(v.numpy())),
                KVCache(k=k.clone(), v=v.clone()))
    (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
    j = JCache(k=jnp.asarray(kq.numpy()), v=jnp.asarray(vq.numpy()),
               k_scale=jnp.asarray(ks.numpy()), v_scale=jnp.asarray(vs.numpy()))
    return j, KVCache(k=kq.clone(), v=vq.clone(), k_scale=ks.clone(),
                      v_scale=vs.clone())


def _same_slabs(cache, jcache):
    if cache.quantized:
        for name in ("k", "v"):  # one quantization step at most
            got = getattr(cache, name).numpy().astype(np.int32)
            want = np.asarray(getattr(jcache, name)).astype(np.int32)
            assert np.abs(got - want).max() <= 1
        for name in ("k_scale", "v_scale"):
            np.testing.assert_allclose(getattr(cache, name).numpy(),
                                       np.asarray(getattr(jcache, name)),
                                       **TOL)
        return
    for name in ("k", "v"):
        np.testing.assert_allclose(getattr(cache, name).numpy(),
                                   np.asarray(getattr(jcache, name)), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("attn", ["dense", "kernel"])
def test_decode_step_per_row_positions_match_jax(rng, monkeypatch,
                                                 quantized, attn):
    """decode_step at a (B,) pos: row 0 an empty slot at pos 0 (only its
    own K/V), the others at distinct ends; three steps, each row's logits
    and the slab each step writes (every row at its own slot) against the
    JAX decoder's per-example path. ``attn`` 'kernel' runs K2's plain
    version at the per-row ends, 'dense' the masked dense path."""
    cfg, jp, tp, tcfg = _decoders()
    b, s = 3, 24
    jcache, cache = _slabs(rng, cfg, b, s, quantized)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    pos = np.array([0, 7, 19], np.int64)
    tok = np.array([5, 700, 33], np.int64)
    monkeypatch.setenv("ASR_DECODE_ATTN", attn)
    for _ in range(3):
        jlog, jcache = jdec.decode_step(jp, jnp.asarray(tok, jnp.int32),
                                        jnp.asarray(pos, jnp.int32), jcache)
        tlog, cache = tdec.decode_step(tp, T(tok), T(pos), cache)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _same_slabs(cache, jcache)
        tok = np.argmax(np.asarray(jlog), -1).astype(np.int64)
        pos = pos + 1
    assert not tdec._use_fused_step(tp, torch.device("cpu"), pos=T(pos))


def test_decode_step_per_row_equals_each_row_alone(rng):
    """Row b of a per-row step equals a B = 1 step at pos[b] on row b's
    slab (the shared-position path): rows do not see each other."""
    cfg, _, tp, tcfg = _decoders()
    _, cache = _slabs(rng, cfg, 3, 24, False)
    tdec = TextDecoder(tcfg, 64)
    pos, tok = torch.tensor([0, 7, 19]), torch.tensor([5, 700, 33])
    rows = [KVCache(k=cache.k[:, i:i + 1].clone(),
                    v=cache.v[:, i:i + 1].clone()) for i in range(3)]
    logits, cache = tdec.decode_step(tp, tok, pos, cache)
    for i in range(3):
        one, rows[i] = tdec.decode_step(tp, tok[i:i + 1], int(pos[i]),
                                        rows[i])
        np.testing.assert_allclose(logits[i:i + 1].numpy(), one.numpy(),
                                   **TOL)
        np.testing.assert_allclose(cache.k[:, i].numpy(),
                                   rows[i].k[:, 0].numpy(), **TOL)


def test_prefill_per_row_true_len_matches_jax(rng):
    """prefill with a (B,) true_len picks each row's own last hidden."""
    cfg, jp, tp, tcfg = _decoders()
    hidden = (rng.standard_normal((3, 12, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    true_len = np.array([12, 5, 9], np.int32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    jlog, jcache = jdec.prefill(jp, jnp.asarray(hidden), jnp.arange(12),
                                JCache.zeros(cfg, 3, 16, jnp.float32),
                                jnp.asarray(true_len))
    tlog, cache = tdec.prefill(tp, T(hidden), torch.arange(12),
                               KVCache.zeros(tcfg, 3, 16, torch.float32),
                               true_len.tolist())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
    _same_slabs(cache, jcache)
    for i, n in enumerate(true_len):  # = the shared-length prefill per row
        one, _ = tdec.prefill(tp, T(hidden[i:i + 1]), torch.arange(12),
                              KVCache.zeros(tcfg, 1, 16, torch.float32),
                              int(n))
        np.testing.assert_allclose(tlog[i:i + 1].numpy(), one.numpy(), **TOL)


@pytest.mark.parametrize("quantized", [False, True])
def test_prefill_chunk_matches_jax(rng, quantized):
    """Three chunks of 8 over a 20-token prompt (the last holds 4): each
    chunk's logits and the slab against JAX's prefill_chunk; the last
    chunk's logits equal the monolithic prefill's on a float slab."""
    cfg, jp, tp, tcfg = _decoders()
    hidden = (rng.standard_normal((1, 24, cfg.hidden_size)) * 0.5).astype(
        np.float32)
    jdec, tdec = JDecoder(cfg, max_position=64), TextDecoder(tcfg, 64)
    jcache = JCache.zeros(cfg, 1, 24, jnp.float32, quantized=quantized)
    cache = KVCache.zeros(tcfg, 1, 24, torch.float32, quantized=quantized)
    for start in (0, 8, 16):
        true_in = min(8, 20 - start)
        chunk = hidden[:, start:start + 8]
        jlog, jcache = jdec.prefill_chunk(jp, jnp.asarray(chunk),
                                          jnp.int32(start), jcache,
                                          jnp.int32(true_in))
        tlog, cache = tdec.prefill_chunk(tp, T(chunk), start, cache, true_in)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **TOL)
        _same_slabs(cache, jcache)
    if not quantized:
        whole, _ = tdec.prefill(tp, T(hidden[:, :20]), torch.arange(20),
                                KVCache.zeros(tcfg, 1, 24, torch.float32), 20)
        np.testing.assert_allclose(tlog.numpy(), whole.numpy(), **TOL)


# ---------------------------------------------------------------------
# sampled serving against JAX's batcher


def jax_batcher(pair, **kw):
    from qwen3_asr_rs_tpu.runtime.serving import ContinuousBatcher as JB

    return JB(pair.jax, **kw)


def run_plan(batcher, plan, request, probe=None, max_iters=400):
    """Submit each (scheduler step, clip, request keywords) of ``plan`` at
    its step and drive the batcher until every request is done; returns
    the raw outputs and ``probe(batcher)`` after every step."""
    pending, reqs, seen = list(plan), [], []
    for it in range(max_iters):
        while pending and pending[0][0] <= it:
            _, c, kw = pending.pop(0)
            reqs.append(request(c, **kw))
            batcher.submit(reqs[-1])
        if not pending and all(r.event.is_set() for r in reqs):
            return [r.result.raw_output for r in reqs], seen
        batcher.step(block_timeout=0.001)
        if probe is not None:
            seen.append(probe(batcher))
    raise AssertionError("batcher did not converge")


# greedy, sampled and nucleus requests: a batched admission (bucket 2), a
# chunked one mid-flight (64000 samples: a prompt over 16 tokens), a
# capped one; one pool of 4 slots
BURST = [(0, clip(100, 20000), dict(temperature=0.9)),
         (0, clip(101, 9000), {}),
         (0, clip(102, 16000), dict(temperature=0.8, top_p=0.9)),
         (3, clip(103, 30000), dict(temperature=1.0)),
         (3, clip(104, 12000), {}),
         (5, clip(105, 64000), dict(temperature=0.7, top_p=0.8)),
         (9, clip(106, 8000), dict(temperature=1.0, max_new_tokens=5))]


@pytest.mark.parametrize("seed", ["0", "7", "12345"])
def test_mixed_burst_matches_jax_batcher(monkeypatch, seed):
    """ASR_SAMPLING_SEED, the same burst through JAX's ContinuousBatcher
    and the port's: every request's raw output equal, and the pool's key
    chain and admission count equal after every scheduler step (a
    departure of the schedule would show here first)."""
    from qwen3_asr_rs_tpu.runtime.serving import Request as JRequest

    monkeypatch.setenv("ASR_SAMPLING_SEED", seed)
    pair = engines(max_new=12)
    kw = dict(n_slots=4, segment_steps=2, prefill_chunk_tokens=16)
    want, jseen = run_plan(jax_batcher(pair, **kw), BURST, JRequest,
                           lambda b: (np.asarray(b.d_key).tolist(),
                                      b._admit_seq))
    got, tseen = run_plan(ContinuousBatcher(pair.port, **kw), BURST,
                          Request, lambda b: (b.d_key.tolist(),
                                              b._admit_seq))
    assert got == want
    assert tseen == jseen
    assert len({tuple(k) for k, _ in tseen}) > 4  # the chain moved


def test_pool_key_chain_follows_jax(monkeypatch):
    """JAX's pool chain, pinned: greedy segments leave the key alone; each
    step of a sampled segment splits it once (key <- fold_in(key, 0));
    every admission prefill, each chunk of a chunked one included, takes
    the next fold_in(base, n). So a sampled request's tokens depend on the
    sampled steps run before it (a JAX behaviour the port keeps)."""
    from qwen3_asr_rs_tpu_torch.ops import prng

    monkeypatch.setenv("ASR_SAMPLING_SEED", "5")
    pair = engines(max_new=6)
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=3,
                          prefill_chunk_tokens=24)
    base = prng.prng_key(5)
    assert torch.equal(b.d_key, base) and torch.equal(b.d_base, base)
    run_all(b, [Request(clip(110, 9000))])  # greedy: no split
    assert torch.equal(b.d_key, base) and b._admit_seq == 1
    steps = b.stats["steps"]
    run_all(b, [Request(clip(111, 9000), temperature=0.8)])
    want = base
    for _ in range(b.stats["steps"] - steps):
        want = prng.split(want)[0]
    assert torch.equal(b.d_key, want) and b._admit_seq == 2
    seq = b._admit_seq
    long_req = Request(clip(112, 64000))  # chunked: a key per chunk
    prompt_len = b._prepare(long_req)[4]
    assert prompt_len > 24
    run_all(b, [long_req])
    assert b._admit_seq - seq == -(-prompt_len // 24)
    # the same request later in the chain draws other tokens
    a = run_all(b, [Request(clip(111, 9000), temperature=0.8)])
    assert a != run_all(b, [Request(clip(111, 9000), temperature=0.8)])


# ---------------------------------------------------------------------
# the scheduler (ports of tests/test_serving.py's cases)


@pytest.mark.parametrize("case,buckets,kw,lengths,encodes,prefills", [
    # three same-bucket requests at one step: one batched prefill
    ("batched", (2, 4, 8), dict(prefill_chunk_tokens=None),
     (8000, 9000, 10000), 3, 1),
    # a prompt over the chunk size: prefilled in chunks, not in one pass
    ("chunked", (2, 4, 8), dict(prefill_chunk_tokens=16), (20000,), 1, 0),
    # 16 chunks in groups of one 8-chunk window: two encoder calls
    ("segmented", (2, 16), dict(prefill_chunk_tokens=64,
                                encode_window_groups=1), (192000,), 2, 0),
])
def test_pool_counts_its_admission_work(case, buckets, kw, lengths, encodes,
                                        prefills):
    """``stats["encodes"]`` counts the pool's encoder calls and
    ``stats["prefills"]`` its one-pass admission prefills, each request
    still equal to its offline run."""
    pair = engines(buckets=buckets)
    b = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2, **kw)
    clips = [clip(40 + i, n) for i, n in enumerate(lengths)]
    assert run_all(b, [Request(c) for c in clips]) == [
        pair.offline(c) for c in clips]
    assert (b.stats["encodes"], b.stats["prefills"]) == (encodes, prefills)


def test_single_request_matches_offline_engines():
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    c = clip(1, 20000)
    assert run_all(b, [Request(c)]) == [pair.offline(c)]
    assert b.stats["segments"] >= 2 and b.stats["captures"] == 0


def test_short_request_not_held_by_long():
    """A request with a short decode completes while a longer one is
    still generating (per-request early return)."""
    pair = engines(max_new=16)
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    long_req = Request(clip(2, 32000), max_new_tokens=16)
    short_req = Request(clip(3, 8000), max_new_tokens=2)
    b.submit(long_req)
    b.submit(short_req)
    drive(b, lambda: short_req.event.is_set())
    assert not long_req.event.is_set()
    assert len(short_req.result.raw_output.split()) <= 2
    drive(b, lambda: long_req.event.is_set())
    assert long_req.result is not None
    assert long_req.finish_time > short_req.finish_time


def test_mid_flight_admission():
    """A request arriving while another decodes is admitted at the next
    segment boundary and overtakes it; both equal their offline runs."""
    pair = engines(max_new=16)
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    first = Request(clip(4, 16000))
    b.submit(first)
    b.step()  # admit + first segment
    assert not first.event.is_set()
    second = Request(clip(5, 16000), max_new_tokens=2)
    b.submit(second)
    drive(b, lambda: second.event.is_set())
    assert not first.event.is_set()
    drive(b, lambda: first.event.is_set())
    assert first.result.raw_output == pair.offline(first.samples)
    assert second.result.raw_output.split() == pair.offline(
        second.samples).split()[:2]


def test_mixed_lengths_match_individual_runs():
    """Slots are isolated: concurrent mixed-bucket requests (bucket 2
    batched, bucket 4 alone) each give the offline engines' tokens."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2)
    clips = [clip(10 + i, n) for i, n in enumerate((8000, 30000, 64000,
                                                    16000))]
    assert run_all(b, [Request(c) for c in clips]) == [
        pair.offline(c) for c in clips]
    assert b.batch_shapes == {(2, 4)}


def test_serving_loop_stop_and_join():
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=1, segment_steps=1)
    loop = ServingLoop(b)
    loop.start()
    req = Request(clip(6, 8000))
    b.submit(req)
    assert req.wait(timeout=120).raw_output == pair.offline(req.samples)
    loop.stop()
    loop.join(timeout=30)
    assert not loop.is_alive()


def test_serving_loop_fails_in_flight_requests_when_an_iteration_raises():
    """An iteration that raises fails the requests in flight (their
    clients get an error, not a hang), marks every slot done on the
    device too, and the loop keeps serving."""
    pair = engines(max_new=16)
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    b.submit(Request(clip(7, 8000)))
    b.step()
    victim = b.slots[0].request
    assert victim is not None
    calls = {"n": 0}
    real_drain = b._drain

    def broken_drain():
        calls["n"] += 1
        if calls["n"] == 1:
            raise RuntimeError("device fault")
        real_drain()

    b._drain = broken_drain
    loop = ServingLoop(b)
    loop.start()
    with pytest.raises(RuntimeError, match="serving loop failure"):
        victim.wait(timeout=60)
    assert bool(b.d_done.all())
    after = Request(clip(8, 8000))
    b.submit(after)
    assert after.wait(timeout=120).raw_output == pair.offline(after.samples)
    loop.stop()
    loop.join(timeout=30)
    assert not loop.is_alive()


def test_oversized_request_rejected():
    b = ContinuousBatcher(engines().port, n_slots=1, segment_steps=1)
    with pytest.raises(ValueError, match="chunks"):
        b.submit(Request(np.zeros(16000 * 20, np.float32)))  # > 8 chunks


def test_slab_headroom_scales_with_segment_steps():
    """s_max headroom covers any segment_steps, not just the default 8,
    and no slot writes past its prompt bucket + max_new (the device cap):
    a slot's position stops at its last token's."""
    eng = engines().port
    small = ContinuousBatcher(eng, n_slots=2, segment_steps=2)
    big = ContinuousBatcher(eng, n_slots=2, segment_steps=24)
    assert big.s_max - big.max_new >= 24 + (small.s_max - small.max_new - 8)
    assert small.s_max - small.max_new >= 8
    c = clip(9, 20000)
    req = Request(c)
    run_all(big, [req])
    prompt_len = big._prepare(req)[4]
    n = len(req.result.raw_output.split())
    # capped: the last token's position; stopped by an EOS: one past it
    last = prompt_len + n - (n == big.max_new)
    assert int(big.d_pos[0]) == last < big.s_max


def test_request_validation():
    for bad in (0.0, -0.2, 1.5):
        with pytest.raises(ValueError, match="top_p"):
            Request(np.zeros(1600, np.float32), top_p=bad)
    with pytest.raises(ValueError, match="temperature"):
        Request(np.zeros(1600, np.float32), temperature=-0.1)


def test_kv_dtype_and_precision_validation():
    eng = engines().port
    with pytest.raises(ValueError, match="kv_dtype"):
        ContinuousBatcher(eng, n_slots=1, kv_dtype="fp8")
    with pytest.raises(ValueError, match="serving_precision"):
        ContinuousBatcher(eng, n_slots=2, serving_precision="fp4")


def test_max_chunks_validation_and_default_clamp():
    """max_chunks below the smallest bucket is rejected; with default
    arguments an engine whose smallest bucket exceeds 120 chunks still
    builds a batcher, at that bucket."""
    with pytest.raises(ValueError, match="smallest engine bucket"):
        ContinuousBatcher(engines().port, n_slots=1, max_chunks=1)
    cfg = _tiny(tconfig)
    eng = AsrEngine(None, dtype=torch.float32, max_new_tokens=2,
                    chunk_buckets=(128, 240), config=cfg, params=(
                        init_encoder_params(_tiny(jconfig).audio,
                                            dtype=jnp.float32),
                        init_decoder_params(_tiny(jconfig).text,
                                            dtype=jnp.float32)),
                    tokenizer=_Tok(), device="cpu")
    assert ContinuousBatcher(eng, n_slots=1, segment_steps=1).max_chunks == 128


def test_batcher_frees_the_engines_kept_slabs():
    """The batcher owns its slab: the engine's kept first-stage slab of a
    transcription before it is freed when a batcher is built."""
    pair = engines()
    pair.port.transcribe_samples(clip(1, 20000))
    assert pair.port._arenas
    ContinuousBatcher(pair.port, n_slots=1, segment_steps=1)
    assert not pair.port._arenas


def test_requests_are_thread_safe_handles():
    """submit from several threads while the loop serves: every request
    completes with its offline output."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    loop = ServingLoop(b)
    loop.start()
    clips = [clip(20 + i, 8000 + 3000 * i) for i in range(4)]
    reqs = [Request(c) for c in clips]
    threads = [threading.Thread(target=b.submit, args=(r,)) for r in reqs]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    try:
        assert [r.wait(timeout=120).raw_output for r in reqs] == [
            pair.offline(c) for c in clips]
    finally:
        loop.stop()
        loop.join(timeout=30)
    assert not loop.is_alive()
