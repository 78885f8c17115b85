"""The decode loop on device state: the port against the JAX engine.

float32 greedy tokens of ``AsrEngine.transcribe_batch`` equal the JAX
engine's exactly across a slab-segment grow (``ASR_DECODE_SEGMENT=2``,
``max_new_tokens=8``: caps [2, 8], one grow), at B = 1 and at B = 3 -> 4
(a born-done row), with a float and an int8 KV slab, on
``tiny_test_config()`` and on two layers at the real 0.6B widths. With a
scripted step function (EOS at different steps per row, a row at the
cap, a pad row) the loop's ``out_buf`` / ``n_gen`` equal a direct
transcription of the JAX loop body (``engine.py:731-771``) at every chunk
size. ``KVCache.grow`` equals the JAX engine's ``grow_cache``; a decode
step at a device position equals the same step at a host int.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
from qwen3_asr_rs_tpu.ops.rotary import RotaryTable as JRotary
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache, TextDecoder
from qwen3_asr_rs_tpu_torch.ops.rotary import RotaryTable
from qwen3_asr_rs_tpu_torch.runtime.engine import EOS_TOKEN_IDS
from qwen3_asr_rs_tpu_torch.utils.tracing import GLOBAL_TIMINGS
from qwen3_asr_rs_tpu_torch.weights import convert
from test_torch_engine import _engines, _real2, _tiny

T = torch.from_numpy


def _clips(lengths):
    return [(np.random.default_rng(10 + i).standard_normal(n) * 0.1).astype(
        np.float32) for i, n in enumerate(lengths)]


# (recipe, chunk buckets, clip lengths): three prompt lengths in one bucket
RECIPES = {
    "tiny": (_tiny, (2,), (16000, 30000, 20000)),
    "real2": (_real2, (1,), (12000, 9000, 15000)),
}


@pytest.mark.parametrize("kv", [None, "int8"])
@pytest.mark.parametrize("recipe", ["tiny", "real2"])
def test_loop_tokens_match_jax_across_a_grow(recipe, kv, monkeypatch):
    """Fresh engines under ASR_DECODE_SEGMENT=2 (JAX reads it when it
    traces a graph): B = 1 and B = 3 (-> 4, one born-done row)."""
    monkeypatch.setenv("ASR_DECODE_SEGMENT", "2")
    if kv:
        monkeypatch.setenv("ASR_KV", kv)
    make, buckets, lengths = RECIPES[recipe]
    jeng, teng = _engines(make, jnp.float32, torch.float32, 8, buckets)
    assert teng.kv_quant == (kv == "int8") and teng._segment_caps() == [2, 8]
    clips = _clips(lengths)
    want = [r.raw_output for r in jeng.transcribe_batch(clips)]
    got = [r.raw_output for r in teng.transcribe_batch(clips)]
    assert got == want
    st = teng.last_stats
    assert st["n_gen"][3] == 0 and len(st["slab_lens"]) == 2
    assert st["slab_lens"][0] < st["slab_lens"][1]
    assert st["decode_steps"] == 7 and st["steps_past_done"] == 0
    assert (teng.transcribe_samples(clips[0]).raw_output
            == jeng.transcribe_samples(clips[0]).raw_output)
    assert len(teng.last_stats["slab_lens"]) == 2


# ---- the loop against JAX's loop body, with a scripted step ------------


def _jax_body_loop(table, live, max_new, caps):
    """A direct transcription of the JAX engine's decode stages: per
    stage ``while any(~done) and step < cap`` of the body (engine.py:
    731-771), whose step makes token table[:, step + 1]."""
    b = table.shape[0]
    out_buf = np.zeros((b, max_new), np.int64)
    n_gen = np.zeros(b, np.int64)
    done = ~live
    tok, step = table[:, 0], 0
    for cap in caps:
        while (~done).any() and step < cap:
            is_eos = np.isin(tok, EOS_TOKEN_IDS)
            newly_done = done | is_eos
            out_buf[np.arange(b), n_gen] = tok
            n_gen = np.where(newly_done, n_gen, n_gen + 1)
            tok = table[:, step + 1]
            done = newly_done
            step += 1
    return out_buf, n_gen


def _script(b, max_new, eos_at, seed):
    """(b, max_new + 1) token table: random non-EOS ids, an EOS at token
    ``eos_at[r]`` of row r (None: never)."""
    table = np.random.default_rng(seed).integers(1000, 2000, (b, max_new + 1))
    for r, at in enumerate(eos_at):
        if at is not None:
            table[r, at] = EOS_TOKEN_IDS[r % 2]
    return table


def _scripted_engine(teng, table, b):
    """Replace the prefill's logits and the decode steps by the table:
    the prefill's argmax is token 0, step s makes token s + 1."""
    tab = T(table)
    onehot = torch.nn.functional.one_hot(tab[:, 0], 151936).float()
    dec = teng.decoder

    def step(params, tok, slot, *rest, counts=None):
        return tab[:, teng._state(b).step + 1], rest[-1]

    dec.prefill = lambda params, hidden, pos, cache, n, counts=None: (
        onehot, cache)
    dec.prefill_aligned = lambda params, hidden, kv_start, cache, counts=None: (
        onehot, cache)
    dec.decode_step_token = dec.decode_step_aligned_token = step


SCRIPTS = {
    # B = 4 (3 live): EOS at token 5, EOS first, a row at the cap
    "cap": (3, (5, 0, None), 21),
    # every row done early: later stages are skipped
    "early": (3, (2, 6, 1), 22),
    "single": (1, (9,), 23),
}


@pytest.mark.parametrize("segment", ["2", "3", "256"])
@pytest.mark.parametrize("chunk", [1, 2, 3, 8])
@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_loop_matches_jax_body(script, chunk, segment, monkeypatch):
    monkeypatch.setenv("ASR_DECODE_SEGMENT", segment)
    n_real, eos_at, seed = SCRIPTS[script]
    max_new = 12
    _, teng = _engines(_tiny, jnp.float32, torch.float32, max_new, (2,))
    teng.decode_chunk = chunk
    b = 1 << (n_real - 1).bit_length()
    live = np.arange(b) < n_real
    table = _script(b, max_new, list(eos_at) + [None] * (b - n_real), seed)
    _scripted_engine(teng, table, b)
    teng.transcribe_batch(_clips([16000] * n_real))
    want_buf, want_n = _jax_body_loop(table, live, max_new,
                                      teng._segment_caps())
    st = teng.last_stats
    assert st["n_gen"] == want_n.tolist()
    got_buf = teng._state(b).out_buf.numpy()
    for r in range(b):
        assert got_buf[r, :want_n[r]].tolist() == want_buf[r, :want_n[r]].tolist()
    # the steps each row needed: up to its EOS, or all max_new - 1
    need = max(want_n[r] if eos_at[r] is not None else max_new - 1
               for r in range(n_real))
    assert st["decode_steps"] - st["steps_past_done"] == need
    assert 0 <= st["steps_past_done"] <= 2 * chunk - 1
    assert st["decode_steps"] <= max_new - 1 and st["replays"] == 0
    # a stage is entered only while a row is live
    caps = teng._segment_caps()
    stages = 1 + sum(1 for c in caps[:-1] if c <= need)
    assert len(st["slab_lens"]) == min(stages, len(caps))


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_scripted_out_buf_independent_of_chunk(script):
    """Steps after every row is done change neither out_buf nor n_gen:
    the whole buffer is the same at every chunk size."""
    n_real, eos_at, seed = SCRIPTS[script]
    b = 1 << (n_real - 1).bit_length()
    bufs = []
    for chunk in (1, 5):
        _, teng = _engines(_tiny, jnp.float32, torch.float32, 12, (2,))
        teng.decode_chunk = chunk
        table = _script(b, 12, list(eos_at) + [None] * (b - n_real), seed)
        _scripted_engine(teng, table, b)
        teng.transcribe_batch(_clips([16000] * n_real))
        bufs.append((teng._state(b).out_buf.clone(), teng.last_stats["n_gen"]))
    assert torch.equal(bufs[0][0], bufs[1][0]) and bufs[0][1] == bufs[1][1]


def test_warmup_captures_the_first_stage_and_runs_no_step(monkeypatch):
    """warmup: every row born done, the first stage's slab made and kept
    per batch size, no decode step on the CPU (no graph to capture), its
    stage timers recorded."""
    monkeypatch.setenv("ASR_DECODE_SEGMENT", "2")
    _, teng = _engines(_tiny, jnp.float32, torch.float32, 8, (1, 2))
    teng.warmup(batch_sizes=(1, 3), buckets=(1, 2))
    st = teng.last_stats
    assert st["decode_steps"] == 0 and st["n_gen"] == [0, 0, 0, 0]
    assert len(st["slab_lens"]) == 1 and st["captures"] == 0
    assert sorted(teng._arenas) == [1, 4]
    for c in (1, 2):
        for b in (1, 3):
            assert GLOBAL_TIMINGS.counts[f"warmup_c{c}_b{b}"] >= 1


@pytest.mark.parametrize("segment", ["2", "8"])
def test_first_stage_slab_kept_until_a_call_leaves_it(segment, monkeypatch):
    """A call that ends within the first stage keeps that stage's slab
    for the next call of its batch size; a call that decodes past it
    frees it, and its later stages go with it (the engine holds no other
    slab). The tokens do not depend on it."""
    monkeypatch.setenv("ASR_DECODE_SEGMENT", segment)
    _, teng = _engines(_tiny, jnp.float32, torch.float32, 8, (2,))
    clips = _clips((16000, 30000, 20000))
    outs = []
    for _ in range(2):
        outs.append([r.raw_output for r in teng.transcribe_batch(clips)])
        one_stage = len(teng.last_stats["slab_lens"]) == 1
        assert one_stage == (segment == "8")
        assert sorted(teng._arenas) == ([4] if one_stage else [])
    assert outs[0] == outs[1]


# ---- the pieces ----------------------------------------------------------


def _jax_grow_cache(cache, b, new_len, cfg, dtype, quantized):
    """The JAX engine's grow_cache (engine.py:785-810), transcribed."""
    bigger = JCache.zeros(cfg, b, new_len, dtype=dtype, quantized=quantized)
    upd = jax.lax.dynamic_update_slice
    return JCache(
        k=upd(bigger.k, cache.k, (0, 0, 0, 0, 0)),
        v=upd(bigger.v, cache.v, (0, 0, 0, 0, 0)),
        k_scale=None if not quantized else upd(bigger.k_scale, cache.k_scale,
                                               (0, 0, 0, 0)),
        v_scale=None if not quantized else upd(bigger.v_scale, cache.v_scale,
                                               (0, 0, 0, 0)),
    )


@pytest.mark.parametrize("quantized", [False, True])
def test_kv_cache_grow_matches_jax(rng, quantized):
    from qwen3_asr_rs_tpu.config import tiny_test_config

    cfg = tiny_test_config().text
    b, n, new = 3, 10, 24
    shape = (cfg.num_hidden_layers, b, cfg.num_key_value_heads, n,
             cfg.head_dim)
    if quantized:
        k, v = (rng.integers(-127, 128, shape).astype(np.int8)
                for _ in range(2))
        ks, vs = (rng.uniform(0, 1, shape[:-1]).astype(np.float32)
                  for _ in range(2))
    else:
        k, v = (rng.standard_normal(shape).astype(np.float32)
                for _ in range(2))
        ks = vs = None
    jc = JCache(k=jnp.asarray(k), v=jnp.asarray(v),
                k_scale=None if ks is None else jnp.asarray(ks),
                v_scale=None if vs is None else jnp.asarray(vs))
    want = _jax_grow_cache(jc, b, new, cfg, jnp.float32, quantized)
    got = KVCache(T(k), T(v), None if ks is None else T(ks),
                  None if vs is None else T(vs)).grow(new)
    assert got.max_len == new
    for g, w in zip(dataclasses.astuple(got), (want.k, want.v, want.k_scale,
                                               want.v_scale)):
        if w is None:
            assert g is None
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_lookup_at_matches_lookup_pos_and_jax():
    cfg = tconfig.tiny_test_config().text
    kw = dict(head_dim=cfg.head_dim, rope_theta=cfg.rope_theta,
              mrope_section=cfg.mrope_section(), max_position=64)
    table = RotaryTable(**kw)
    for pos in (0, 17, 63):
        got = table.lookup_at(torch.tensor(pos))
        for g, w in zip(got, table.lookup_pos(pos)):
            assert torch.equal(g, w)
        jc, _ = JRotary(**kw).lookup_batch(jnp.asarray([pos]))
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(jc))
    cos, _ = table.lookup_at(torch.tensor([3, 9]))
    assert cos.shape == (2, cfg.head_dim)


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("impl", ["scan", "fused"])
def test_decode_steps_at_device_slot_equal_host_int(rng, monkeypatch, impl,
                                                    quantized):
    """decode_step / decode_step_aligned at a 0-d device slot: the same
    logits and slab as at the host int (the left-aligned and the
    right-aligned step, the plain per-layer and K1's plain path)."""
    monkeypatch.setenv("ASR_DECODE_IMPL", impl)
    cfg = tconfig.tiny_test_config().text
    params = convert.to_torch(convert.init_decoder_params_np(cfg),
                              torch.float32)
    dec = TextDecoder(cfg, 64)
    b, s_max, slot = 3, 20, 12
    tok = T(rng.integers(0, cfg.vocab_size, b))
    kv_start = T(np.asarray([0, 3, 7], np.int32))

    def fresh():
        c = KVCache.zeros(cfg, b, s_max, torch.float32, quantized=quantized)
        g = np.random.default_rng(5)
        c.k.copy_(T(g.standard_normal(c.k.shape)).to(c.k.dtype))
        c.v.copy_(T(g.standard_normal(c.v.shape)).to(c.v.dtype))
        if quantized:
            c.k_scale.copy_(T(g.uniform(0.01, 0.02, c.k_scale.shape)))
            c.v_scale.copy_(T(g.uniform(0.01, 0.02, c.v_scale.shape)))
        return c

    for fn, extra in ((dec.decode_step, ()),
                      (dec.decode_step_aligned, (kv_start,))):
        ca, cb = fresh(), fresh()
        la, _ = fn(params, tok, slot, *extra, ca)
        lb, _ = fn(params, tok, torch.tensor(slot), *extra, cb)
        assert torch.equal(la, lb)
        for x, y in zip(dataclasses.astuple(ca), dataclasses.astuple(cb)):
            assert (x is None and y is None) or torch.equal(x, y)
