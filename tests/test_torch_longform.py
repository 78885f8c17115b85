"""Long-form transcription: the port's ``runtime/longform.py`` (a copy of
the JAX package's) and ``AsrEngine.transcribe`` on audio longer than the
largest bucket, against the JAX package.

Each function of the copy gives JAX's result on the inputs of
``tests/test_longform.py``. In float32 on the tiny config (an 8 s largest
bucket, a 20 s clip, 1 s overlap, 2 new tokens), ``transcribe`` gives the
JAX engine's text, raw output and segments, batched and with
``batch_chunks=1``; segment ends do not overlap; the batch clamp counts
the compiled bucket; short audio carries one segment with words.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import qwen3_asr_rs_tpu.runtime.longform as jlf
import qwen3_asr_rs_tpu_torch.runtime.longform as tlf
from test_torch_engine import _engines, _tiny

JOIN_CASES = [
    ("a b c d e f g".split(), "e f g h i j".split()),
    ("the quick brown fox jumps xx".split(),
     "yy fox jumps over the lazy dog".split()),
    ("a b c".split(), "x y z".split()),
    (("intro words " + "yeah " * 30).split(),
     ("yeah " * 5 + "and then we left").split()),
    ("we said hello world early on and closed differently".split(),
     "hello world is how the next clip starts".split()),
]

STITCH_CASES = [
    ["one two three four", "three four five six", "five six seven eight"],
    [],
    ["solo"],
    ["你好，这是语音合成系统", "语音合成系统的持续集成测试。"],
    ["你好，这是 Qwen3 语音合成", "Qwen3 语音合成系统的测试。"],
    ["你好。", "世界。"],
    ["hello there", "general kenobi"],
    ["今天天气很好我们去公园玩耍x", "y去公园玩耍然后回家吃饭"],
    ["。　好的近况", "　好，那我们"],
    ["one two three four", "three four five six", "five six seven"],
    ["a b c", "x y z"],
    ["今天天气很好我们出去", "我们出去散步吧"],
    ["", "starts empty", "empty ends", ""],
]

WORD_CASES = [("hello world", 0.0, 8.0), ("你好世界", 2.0, 6.0),
              ("", 0.0, 5.0), ("   ", 0.0, 5.0), ("a b", 3.0, 3.0),
              ("one two", 0.0, 4.0), ("三", 4.0, 6.0)]


def _asdicts(items):
    return None if items is None else [dataclasses.asdict(i) for i in items]


@pytest.mark.parametrize("case", range(len(JOIN_CASES)))
def test_best_join_matches_jax(case):
    prev, nxt = JOIN_CASES[case]
    assert tlf.best_join(prev, nxt) == jlf.best_join(prev, nxt)


@pytest.mark.parametrize("case", range(len(STITCH_CASES)))
def test_stitch_and_spans_match_jax(case):
    segs = STITCH_CASES[case]
    assert tlf.stitch(segs) == jlf.stitch(segs)
    assert tlf.stitch_spans(segs) == jlf.stitch_spans(segs)
    for text in segs:
        assert tlf._split_units(text) == jlf._split_units(text)


@pytest.mark.parametrize("case", range(len(WORD_CASES)))
def test_word_timings_and_attach_words_match_jax(case):
    text, start, end = WORD_CASES[case]
    assert (_asdicts(tlf.word_timings(text, start, end))
            == _asdicts(jlf.word_timings(text, start, end)))
    got = tlf.attach_words([tlf.Segment(0, start, end, text)])
    want = jlf.attach_words([jlf.Segment(0, start, end, text)])
    assert _asdicts(got) == _asdicts(want)
    assert tlf.attach_words(None) is None
    assert tlf.LONGFORM_BATCH_BUDGET_CHUNKS == jlf.LONGFORM_BATCH_BUDGET_CHUNKS


# ---- through the engines -------------------------------------------------


def _pair(max_new=2):
    """(JAX engine, port engine): tiny config, float32, buckets (2, 4, 8)
    (the largest 8 s), the same weights."""
    return _engines(_tiny, jnp.float32, torch.float32, max_new, (2, 4, 8))


@pytest.fixture
def long_wav(tmp_path):
    from test_audio_io import write_wav_pcm16

    wav = tmp_path / "long.wav"
    write_wav_pcm16(wav, np.random.default_rng(8).standard_normal(16000 * 20)
                    * 0.1, 16000)
    return wav


def _same_result(got, want):
    assert (got.text, got.language, got.raw_output) == (
        want.text, want.language, want.raw_output)
    assert _asdicts(got.segments) == _asdicts(want.segments)


def test_longform_transcribe_matches_jax(long_wav):
    """Three 8 s segments (starts 0, 7, 14): batched (B = 2, then 1)."""
    jeng, teng = _pair()
    got = teng.transcribe(long_wav, overlap_seconds=1.0)
    want = jeng.transcribe(str(long_wav), overlap_seconds=1.0)
    _same_result(got, want)
    assert got.raw_output.count("\n") == 2
    assert "".join(s.text for s in got.segments) == got.text
    for s in got.segments:
        assert 0.0 <= s.start < s.end <= 20.0 and s.words is not None


def test_longform_sequential_matches_jax_and_batched():
    jeng, teng = _pair()
    samples = (np.random.default_rng(9).standard_normal(16000 * 20)
               * 0.1).astype(np.float32)
    seq = tlf.transcribe_long(teng, samples, overlap_seconds=1.0,
                              batch_chunks=1)
    _same_result(seq, jlf.transcribe_long(jeng, samples, overlap_seconds=1.0,
                                          batch_chunks=1))
    batched = tlf.transcribe_long(teng, samples, overlap_seconds=1.0)
    assert (batched.text, batched.raw_output) == (seq.text, seq.raw_output)


def test_longform_segments_non_overlapping(monkeypatch):
    _, teng = _pair()
    samples = (np.random.default_rng(10).standard_normal(16000 * 20)
               * 0.1).astype(np.float32)
    monkeypatch.setattr(tlf, "stitch_spans",
                        lambda texts: [(i, t or "x")
                                       for i, t in enumerate(texts)])
    segs = tlf.transcribe_long(teng, samples, overlap_seconds=2.0).segments
    assert len(segs) >= 2
    for a, b in zip(segs, segs[1:]):
        assert a.end <= b.start and a.start <= a.end


def test_longform_batch_clamp_uses_compiled_bucket(monkeypatch):
    _, teng = _pair()
    monkeypatch.setattr(tlf, "LONGFORM_BATCH_BUDGET_CHUNKS", 32)
    seen = []
    orig = teng.transcribe_batch

    def spy(samples_list, languages=None, **kw):
        seen.append(len(samples_list))
        return orig(samples_list, languages, **kw)

    monkeypatch.setattr(teng, "transcribe_batch", spy)
    samples = (np.random.default_rng(11).standard_normal(16000 * 40)
               * 0.1).astype(np.float32)
    tlf.transcribe_long(teng, samples, segment_seconds=5.0,
                        overlap_seconds=1.0)
    assert seen and max(seen) <= 4


def test_short_audio_gets_one_segment_with_words(tmp_path):
    from test_audio_io import write_wav_pcm16

    jeng, teng = _pair(max_new=3)
    wav = tmp_path / "short.wav"
    write_wav_pcm16(wav, np.random.default_rng(12).standard_normal(32000)
                    * 0.1, 16000)
    got = teng.transcribe(wav)
    _same_result(got, jeng.transcribe(str(wav)))
    (seg,) = got.segments
    assert (seg.start, seg.end, seg.text) == (0.0, 2.0, got.text)
    assert [w.word for w in seg.words] == got.text.split()
    assert seg.words[0].start == 0.0 and seg.words[-1].end == 2.0
