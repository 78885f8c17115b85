"""The port's serving admission paths, held against the JAX package
(float32, CPU): chunked and segmented-encode admission, the int8 KV slot
pool, batched admission, precision auto-select, warmup, and sampled and
nucleus requests (ports of ``tests/test_serving.py``'s cases).

"Equal" means a request's raw output through the batcher equals, exactly,
the JAX engine's ``transcribe_samples`` and the port engine's on the same
weights (``test_torch_serving.engines``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import pytest
import torch

from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.runtime.serving import ContinuousBatcher, Request
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant

from test_torch_serving import clip, drive, engines, run_all


def test_chunked_admission_matches_offline_engines():
    """A prompt longer than prefill_chunk_tokens is prefilled in chunks
    and still gives the offline engines' (monolithic) tokens."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2,
                          prefill_chunk_tokens=16)
    c = clip(30, 64000)
    req = Request(c)
    b.submit(req)
    b.step()
    assert 0 in b.prefilling
    drive(b, lambda: req.event.is_set())
    assert req.result.raw_output == pair.offline(c)
    assert not b.prefilling


def test_chunked_admission_interleaves_with_decode():
    """While a long prompt prefills chunk by chunk, an already-decoding
    slot advances every scheduler iteration."""
    pair = engines(max_new=16)
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=1,
                          prefill_chunk_tokens=16)
    decoding = Request(clip(31, 8000))
    b.submit(decoding)
    b.step()  # admit (short prompt: monolithic) + first segment
    assert not decoding.event.is_set()
    long_req = Request(clip(32, 64000), max_new_tokens=2)
    b.submit(long_req)
    b.step()  # admits chunked; still runs a decode segment
    assert 1 in b.prefilling
    pos_before = b.pos[0]
    for _ in range(50):
        if not b.prefilling:
            break
        b.step()
    assert not b.prefilling
    assert b.pos[0] > pos_before or decoding.event.is_set()
    drive(b, lambda: long_req.event.is_set() and decoding.event.is_set())
    assert decoding.result.raw_output == pair.offline(decoding.samples)
    assert long_req.result.raw_output.split() == pair.offline(
        long_req.samples).split()[:2]


def test_segmented_encode_admission_matches_offline_engines():
    """A clip spanning two encoder window groups is encoded one group per
    scheduler step and still gives the offline engines' tokens."""
    pair = engines(max_new=3, buckets=(16,))
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2,
                          prefill_chunk_tokens=16, encode_window_groups=1,
                          max_chunks=16)
    c = clip(33, 16000 * 10)  # 10 chunks -> bucket 16, groups of 8
    req = Request(c)
    b.submit(req)
    b.step()
    assert 0 in b.encoding and b.encoding[0].n_groups == 2
    drive(b, lambda: req.event.is_set())
    assert not b.encoding
    assert req.result.raw_output == pair.offline(c)


@pytest.mark.parametrize("chunk", [None, 16])
def test_int8_kv_pool_matches_engine(chunk):
    """kv_dtype 'int8' (inherited from the engine) == the int8-KV offline
    engines token for token, with monolithic (batched) and with chunked
    admission (a quantized per-admission cache committed with its
    scales)."""
    pair = engines(kv_dtype="int8")
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2,
                          prefill_chunk_tokens=chunk)
    assert b.kv_quant and b.cache.k_scale is not None
    clips = [clip(34, 20000), clip(35, 9000)] if chunk is None else [
        clip(36, 64000)]
    assert run_all(b, [Request(c) for c in clips]) == [
        pair.offline(c) for c in clips]
    if chunk is None:
        assert b.batch_shapes == {(2, 2)}


def test_batched_admission_matches_serialized_and_offline():
    """A same-bucket burst admitted in ONE batched prefill gives exactly
    the tokens of serialized admission and of the offline engines."""
    pair = engines()
    clips = [clip(40 + i, n) for i, n in enumerate((8000, 20000, 16000,
                                                    30000))]
    batched = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2)
    reqs = [Request(c) for c in clips]
    for r in reqs:
        batched.submit(r)
    batched.step(block_timeout=0.001)  # one step admits the whole burst
    assert batched.batch_shapes == {(2, 4)}
    drive(batched, lambda: all(r.event.is_set() for r in reqs))
    serial = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2,
                               admit_batch_max=1)
    want = [pair.offline(c) for c in clips]
    assert run_all(serial, [Request(c) for c in clips]) == want
    assert not serial.batch_shapes
    assert [r.result.raw_output for r in reqs] == want


def test_batched_admission_pads_to_power_of_two():
    """A group of 3 pads to 4 by repeating row 0 (slot included)."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2)
    clips = [clip(50 + i, n) for i, n in enumerate((8000, 20000, 16000))]
    assert run_all(b, [Request(c) for c in clips]) == [
        pair.offline(c) for c in clips]
    assert b.batch_shapes == {(2, 4)}


def test_batched_admission_mixed_buckets_and_temperature():
    """Mixed buckets split into per-bucket groups; a sampled row draws
    its first token in the batched prefill; greedy rows stay exact."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=4, segment_steps=2)
    short = [Request(clip(60 + i, 8000), temperature=0.8 if i == 0 else 0.0)
             for i in range(2)]  # bucket 2
    longs = [Request(clip(62 + i, 64000)) for i in range(2)]  # bucket 4
    out = run_all(b, short + longs)
    assert b.batch_shapes == {(2, 2), (4, 2)}
    assert all(isinstance(o, str) for o in out)
    for r in short[1:] + longs:
        assert r.result.raw_output == pair.offline(r.samples)


def test_precision_auto_select(monkeypatch):
    """Threshold 0: every live segment runs the bf16 (= engine) params and
    the tokens equal the offline engines'; a huge threshold picks the
    int8 copy (lm_bits 8 whatever ASR_LM_BITS says); is_quantized and
    quant_bits agree with JAX's on the same trees."""
    pair = engines()
    monkeypatch.setenv("ASR_SERVING_INT8_MAX_OCC", "0")
    monkeypatch.setenv("ASR_LM_BITS", "4")
    auto = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2,
                             serving_precision="auto")
    assert set(auto._params_by_precision) == {"engine", "bf16", "int8"}
    q8 = auto._params_by_precision["int8"]
    assert "lm_head_q" in q8 and "lm_head_q4" not in q8
    c = clip(70, 20000)
    assert run_all(auto, [Request(c)]) == [pair.offline(c)]
    assert {p for _, p in auto.variants_run} == {"bf16"}

    monkeypatch.setenv("ASR_SERVING_INT8_MAX_OCC", "99")
    b8 = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2,
                           serving_precision="auto")
    r8 = Request(c)
    b8.submit(r8)
    b8.step(block_timeout=0.001)  # admit; slot live
    assert b8._segment_params()[0] == "int8"
    drive(b8, lambda: r8.event.is_set())
    assert isinstance(r8.result.raw_output, str)
    assert {p for _, p in b8.variants_run} == {"int8"}

    jp, tp = pair.jax.dec_params, pair.port.dec_params
    for jtree, ttree in (
            (jp, tp),
            (jquant.quantize_decoder_params(jp, lm_bits=8),
             tquant.quantize_decoder_params(tp, lm_bits=8)),
            (jquant.quantize_decoder_params(jp, bits=4, lm_bits=4),
             tquant.quantize_decoder_params(tp, bits=4, lm_bits=4)),
            (jquant.quantize_lm_head_only(jp),
             tquant.quantize_lm_head_only(tp))):
        assert tquant.is_quantized(ttree) == jquant.is_quantized(jtree)
        assert tquant.quant_bits(ttree) == jquant.quant_bits(jtree)
    int4 = AsrEngine(None, dtype=torch.float32, max_new_tokens=4,
                     chunk_buckets=(2,), config=pair.port.config,
                     params=(pair.port.enc_params, tp),
                     tokenizer=pair.port.tokenizer, device="cpu",
                     quantize="int4")
    with pytest.raises(ValueError, match="UNQUANTIZED"):
        ContinuousBatcher(int4, n_slots=1, serving_precision="int8")


def test_warmup_covers_every_path_and_leaves_the_batcher_idle():
    """warmup() runs every bucket's admission, every batched (bucket,
    size) pair and every segment variant; afterwards no slot is taken,
    nothing is queued, and real traffic matches the offline engines."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    b.warmup()
    assert all(s.request is None for s in b.slots)
    assert b.queue.empty() and b._inflight is None
    assert b.batch_shapes == {(c, 2) for c in pair.port.chunk_buckets}
    assert b.variants_run == {(v, "engine")
                              for v in ("greedy", "sample", "nucleus")}
    c = clip(71, 20000)
    assert run_all(b, [Request(c)]) == [pair.offline(c)]


def test_nucleus_tiny_top_p_matches_greedy():
    """temperature > 0 with a tiny top_p keeps only the top-1 token of
    the scaled distribution: the offline greedy tokens, through the
    admission's first-token draw and the nucleus segment variant."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    c = clip(72, 20000)
    assert run_all(b, [Request(c, temperature=3.0, top_p=1e-6)]) == [
        pair.offline(c)]
    assert ("nucleus", "engine") in b.variants_run


def test_nucleus_row_leaves_greedy_neighbours_exact():
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    greedy = Request(clip(73, 16000))
    nuc = Request(clip(74, 20000), temperature=0.9, top_p=0.8)
    run_all(b, [greedy, nuc])
    assert greedy.result.raw_output == pair.offline(greedy.samples)
    assert isinstance(nuc.result.raw_output, str)
    assert ("nucleus", "engine") in b.variants_run


def test_nucleus_only_when_requested():
    """Temperature-only traffic never runs the nucleus variant; top_p < 1
    at temperature 0 is greedy (OpenAI semantics)."""
    pair = engines()
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=2)
    run_all(b, [Request(clip(75, 12000), temperature=0.7)])
    assert b.variants_run == {("sample", "engine")}
    c = clip(76, 12000)
    assert run_all(b, [Request(c, top_p=0.5)]) == [pair.offline(c)]
    assert ("nucleus", "engine") not in b.variants_run


def _sampled_in(pair, slot: int, batcher, request):
    """A sampled request admitted second into slot ``slot``: slot 0 after
    a one-token request has finished, or slot 1 beside a greedy request
    still decoding. Returns its raw output."""
    b = batcher(pair, n_slots=2, segment_steps=2)
    first = request(clip(77, 16000), max_new_tokens=1 if slot == 0 else None)
    b.submit(first)
    if slot == 0:
        drive(b, lambda: first.event.is_set())
    else:
        b.step()
    sampled = request(clip(78, 20000), temperature=1.0)
    b.submit(sampled)
    b.step()
    assert b.slots[slot].request is sampled
    assert first.event.is_set() == (slot == 0)
    drive(b, lambda: sampled.event.is_set() and first.event.is_set())
    return sampled.result.raw_output


@pytest.mark.parametrize("seed_env", ["0", "12345"])
def test_sampled_tokens_follow_slot_and_pool_as_jax(monkeypatch, seed_env):
    """JAX's batcher draws a sampled request with the pool's key chain at
    its slot's row, so its tokens depend on the slot it lands in and on
    the sampled steps before it: in slot 0 alone and in slot 1 beside a
    decoding neighbour, the port's tokens are JAX's (and not greedy)."""
    from qwen3_asr_rs_tpu.runtime.serving import ContinuousBatcher as JB
    from qwen3_asr_rs_tpu.runtime.serving import Request as JRequest

    monkeypatch.setenv("ASR_SAMPLING_SEED", seed_env)
    pair = engines(max_new=16)
    for slot in (0, 1):
        want = _sampled_in(pair, slot, lambda p, **kw: JB(p.jax, **kw),
                           JRequest)
        got = _sampled_in(pair, slot,
                          lambda p, **kw: ContinuousBatcher(p.port, **kw),
                          Request)
        assert got == want
        assert got != pair.offline(clip(78, 20000))


def test_int8_segments_equal_offline_steps_on_the_int8_tree(monkeypatch):
    """An auto pool whose every segment runs the int8 copy (threshold
    above the live slots): each request's raw output equals, exactly, the
    engine's prefill and first token (admission runs the engine's weights)
    followed by offline decode steps at a shared position over the pool's
    own int8 tree."""
    from qwen3_asr_rs_tpu_torch.runtime.engine import EOS_TOKEN_IDS

    pair = engines(max_new=16)
    monkeypatch.setenv("ASR_SERVING_INT8_MAX_OCC", "99")
    b = ContinuousBatcher(pair.port, n_slots=2, segment_steps=4,
                          serving_precision="auto")
    q8 = b._params_by_precision["int8"]
    assert tquant.quant_bits(q8) == 8
    clips = [clip(80, 20000), clip(81, 50000)]
    got = run_all(b, [Request(c) for c in clips])
    assert {p for _, p in b.variants_run} == {"int8"}
    eng = pair.port
    for c, out in zip(clips, got):
        logits, cache, base = eng.prefill(c)
        toks, tok = [], int(logits[0].argmax())
        while tok not in EOS_TOKEN_IDS:
            toks.append(tok)
            if len(toks) == eng.max_new_tokens:
                break
            logits, _ = eng.decoder.decode_step(
                q8, torch.tensor([tok]), base + len(toks) - 1, cache)
            tok = int(logits[0].argmax())
        assert out == eng.tokenizer.decode(toks)


def test_tmp_cache_longer_than_slab_is_cut():
    """_write_slot_rows drops a chunk-padded cache's overhang past the
    slab."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache
    from qwen3_asr_rs_tpu_torch.runtime.serving import _write_slot_rows

    slab = KVCache(k=torch.zeros(2, 3, 2, 10, 4), v=torch.zeros(2, 3, 2, 10, 4))
    tmp = KVCache(k=torch.randn(2, 1, 2, 16, 4), v=torch.randn(2, 1, 2, 16, 4))
    _write_slot_rows(slab, tmp, [2])
    assert torch.equal(slab.k[:, 2], tmp.k[:, 0, :, :10])
    assert not slab.k[:, :2].any()
    rows = KVCache(k=torch.randn(2, 3, 2, 6, 4), v=torch.randn(2, 3, 2, 6, 4))
    _write_slot_rows(slab, rows, [1, 0, 1])
    assert torch.equal(slab.v[:, 0, :, :6], rows.v[:, 1])
    assert torch.equal(slab.v[:, 1, :, :6], rows.v[:, 2])
