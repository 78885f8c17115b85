"""Streaming transcription in the port (``runtime/streaming.py``).

Mirrors every case of ``tests/test_streaming.py`` on the port (float32,
the CPU): common_prefix_len, monotone commits, a small feed with no
update, a session equal to the offline engine, at most two windows
encoded per update, rollover past capacity, a giant single feed, the
rollover's commit in the update deltas, the carried overlap, and the
mel-floor invalidation against the encode-time max. Beside them: a port
session and a JAX session fed the same audio in the same increments give
equal ``raw_output`` and ``last_update_stats`` at every update; a port
transcriber and a JAX transcriber give equal committed text and deltas
at every update, where the text is rewritten too; two
sessions alive at once on one engine give the tokens each gives alone;
a rollover takes the finished session's slab lease back.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.runtime.streaming import (
    StreamingSession,
    StreamingTranscriber,
    common_prefix_len,
)
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    init_encoder_params_np,
)

# decoder weight scale at which the tiny model's tokens vary (at the
# JAX tests' 0.02 it repeats one token)
VARIED = 0.1


class _Tok:
    def encode(self, text):
        return [100 + (ord(c) % 50) for c in text]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _cfg(module=tconfig):
    cfg = module.tiny_test_config()
    text = dataclasses.replace(cfg.text, vocab_size=151936)
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=text))


def _engine(max_new=4, buckets=(2, 15), scale=0.02):
    """The tiny model with buckets wide enough for multi-window audio
    (JAX's ``_wide_engine``; ``make_engine``'s buckets (2, 4, 8) where the
    JAX test uses it)."""
    cfg = _cfg()
    return AsrEngine(None, dtype=torch.float32, max_new_tokens=max_new,
                     chunk_buckets=buckets, config=cfg,
                     params=(init_encoder_params_np(cfg.audio),
                             init_decoder_params_np(cfg.text, scale=scale)),
                     tokenizer=_Tok(), device="cpu")


def _speechlike(rng, seconds):
    """A signal with an early loud onset, so that the mel max settles."""
    n = int(16000 * seconds)
    x = (rng.standard_normal(n) * 0.05).astype(np.float32)
    x[:8000] += np.sin(2 * np.pi * 300 * np.arange(8000) / 16000).astype(
        np.float32) * 0.8
    return x


def test_common_prefix_len():
    assert common_prefix_len(["hello world", "hello there"]) == 6
    assert common_prefix_len(["abc", "abc"]) == 3
    assert common_prefix_len(["a", ""]) == 0
    assert common_prefix_len([]) == 0


def test_streaming_commits_monotonically(rng):
    stream = StreamingTranscriber(_engine(max_new=4, buckets=(2, 4, 8)),
                                  update_interval_s=1.0, agreement=2)
    committed_history = []
    for _ in range(4):
        update = stream.feed(
            (rng.standard_normal(16000) * 0.1).astype(np.float32))
        if update is not None:
            committed_history.append(stream.committed_text)
    assert len(committed_history) == 4
    assert isinstance(stream.finalize().text, str)
    for a, b in zip(committed_history, committed_history[1:]):
        assert b.startswith(a)


def test_streaming_small_feed_no_update():
    stream = StreamingTranscriber(_engine(max_new=2, buckets=(2, 4, 8)),
                                  update_interval_s=10.0)
    assert stream.feed(np.zeros(100, np.float32)) is None
    assert stream.committed_text == ""


@pytest.mark.parametrize("scale", [0.02, VARIED])
def test_streaming_session_matches_offline_engine(rng, scale):
    """The session (cached windows + chunked prefill) emits the offline
    engine's tokens over the same buffered audio: 11 s (a completed
    window and a 3 s tail) fed in 2 s increments."""
    eng = _engine(max_new=4, scale=scale)
    audio = _speechlike(rng, 11.0)
    session = StreamingSession(eng, max_new_tokens=4)
    for off in range(0, len(audio), 32000):
        session.buffer = audio[: off + 32000]
        result = session.update()
    assert result.raw_output == eng.transcribe_samples(audio).raw_output


def test_streaming_reencodes_at_most_two_windows(rng):
    """After the first update each update encodes <= 2 windows (the one
    just completed and the tail) and prefills a bounded chunk."""
    audio = _speechlike(rng, 14.0)
    session = StreamingSession(_engine(max_new=2), max_new_tokens=2)
    for sec in range(2, 15, 2):
        session.buffer = audio[: sec * 16000]
        session.update()
        if sec > 2:
            stats = session.last_update_stats
            assert stats["windows_encoded"] <= 2, stats
            assert stats["chunk_positions"] <= 2 * 104 + 40, stats


def test_streaming_rollover_past_capacity(rng):
    """A stream longer than the slab rolls over, not raises."""
    stream = StreamingTranscriber(_engine(max_new=2), update_interval_s=2.0,
                                  max_stream_seconds=8.0, max_new_tokens=2)
    for _ in range(10):  # 20 s >> 8 s
        up = stream.feed((rng.standard_normal(32000) * 0.1).astype(
            np.float32))
        assert up is not None
    assert isinstance(stream.finalize().text, str)


def test_giant_single_feed_rolls_over_safely(rng):
    """One feed larger than a session rolls over BEFORE the update,
    several times in one update."""
    stream = StreamingTranscriber(_engine(max_new=2), update_interval_s=1.0,
                                  max_stream_seconds=8.0, max_new_tokens=2)
    up = stream.feed((rng.standard_normal(16000 * 20) * 0.1).astype(
        np.float32))
    assert up is not None
    assert len(stream.session.buffer) <= stream.session.max_samples
    assert isinstance(stream.finalize().text, str)


def test_rollover_commit_appears_in_update_deltas(rng):
    """The StreamUpdate.committed deltas concatenate to the committed
    text, the rollover's own commit included (JAX's test of this name, at
    its weight scale 0.02, where the final hypotheses extend the committed
    text)."""
    stream = StreamingTranscriber(_engine(max_new=2),
                                  update_interval_s=2.0,
                                  max_stream_seconds=8.0, max_new_tokens=2,
                                  agreement=2)
    deltas = []
    for _ in range(10):  # 20 s: at least one rollover
        up = stream.feed((rng.standard_normal(32000) * 0.1).astype(
            np.float32))
        if up is not None:
            deltas.append(up.committed)
    assert stream._rolled
    assert "".join(deltas) == stream.committed_text


def test_rollover_carries_audio_overlap(rng):
    """The session after a rollover starts with the overlap audio, and
    takes the finished session's slab lease back."""
    stream = StreamingTranscriber(_engine(max_new=2), update_interval_s=2.0,
                                  max_stream_seconds=8.0, max_new_tokens=2,
                                  rollover_overlap_s=2.0)
    first = stream.session._slab
    for _ in range(6):  # 12 s: one rollover past 8 s
        stream.feed((rng.standard_normal(32000) * 0.1).astype(np.float32))
    assert stream._rolled and stream._overlap_carried
    assert len(stream.session.buffer) >= stream.rollover_overlap
    assert stream.session._slab is first
    assert stream.session.graphs.leases == 1


def test_mel_floor_invalidation_uses_encode_time_max(rng):
    """A gradual mel-max rise (each step under the tolerance, the sum far
    over) still re-encodes the cached windows: the comparison base is
    the encode-time max, not the running max."""
    session = StreamingSession(_engine(max_new=2), max_new_tokens=2)
    base = _speechlike(rng, 2.0) * 0.001
    session.buffer = base
    session.update()
    assert np.isfinite(session.encode_max)
    first_encode_max = session.encode_max
    audio, amp = [base], 0.001
    for _ in range(1, 6):
        amp *= 2.5
        audio.append(_speechlike(rng, 2.0) * amp)
        session.buffer = np.concatenate(audio)
        session.update()
    assert session.session_max - session.encode_max <= (
        session.MAX_TOLERANCE + 1e-6)
    assert session.encode_max > first_encode_max


def test_session_matches_jax_at_every_update(rng):
    """A port session and a JAX session fed the same audio in the same
    increments (1.5 s steps to 14 s: window completions, a catch-up-free
    tail, a mel max that rises past the tolerance at 9 s) give equal
    raw_output and last_update_stats at every update."""
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
    from qwen3_asr_rs_tpu.runtime.streaming import (
        StreamingSession as JaxSession,
    )

    cfg = _cfg(jconfig)
    jeng = JaxEngine(
        model_dir=None, dtype=jnp.float32, max_new_tokens=6,
        chunk_buckets=(2, 15), config=cfg,
        params=(init_encoder_params(cfg.audio, dtype=jnp.float32),
                init_decoder_params(cfg.text, dtype=jnp.float32,
                                    scale=VARIED)),
        tokenizer=_Tok())
    audio = _speechlike(rng, 14.0)
    audio[9 * 16000:10 * 16000] *= 40.0  # a louder second
    jses = JaxSession(jeng, max_new_tokens=6)
    tses = StreamingSession(_engine(max_new=6, scale=VARIED),
                            max_new_tokens=6)
    outputs = set()
    for end in range(24000, len(audio) + 1, 24000):
        jses.buffer = tses.buffer = audio[:end]
        want, got = jses.update(), tses.update()
        assert got.raw_output == want.raw_output, end
        assert tses.last_update_stats == jses.last_update_stats, end
        assert tses.session_max == pytest.approx(jses.session_max, abs=1e-5)
        outputs.add(got.raw_output)
    assert len(outputs) > 2


def test_two_live_sessions_on_one_engine(rng):
    """Two sessions alive at once on one engine, updated in turn, give
    the hypotheses each gives alone: each holds its own slab lease. (The
    tiny model's tokens hardly depend on the audio, so the second session
    forces a language: another prompt, other tokens.)"""
    eng = _engine(max_new=4, scale=VARIED)
    a, b = _speechlike(rng, 10.0), _speechlike(rng, 10.0)

    def alone(audio, language):
        s = StreamingSession(eng, language, max_new_tokens=4)
        out = []
        for end in range(32000, len(audio) + 1, 32000):
            s.buffer = audio[:end]
            out.append(s.update().raw_output)
        s.close()
        return out

    want_a, want_b = alone(a, None), alone(b, "english")
    sa = StreamingSession(eng, max_new_tokens=4)
    sb = StreamingSession(eng, "english", max_new_tokens=4)
    assert sa._slab is not sb._slab
    got_a, got_b = [], []
    for end in range(32000, len(a) + 1, 32000):
        sa.buffer, sb.buffer = a[:end], b[:end]
        got_a.append(sa.update().raw_output)
        got_b.append(sb.update().raw_output)
    assert (got_a, got_b) == (want_a, want_b)
    assert want_a != want_b
    assert sa.graphs.leases == 2


def test_committed_text_differs_from_jax_only_where_jax_rewrites_it():
    """The port commits as the JAX transcriber does: fed the same 20 s
    (VARIED weights, 8 s sessions, 2 s updates, two rollovers), the
    committed text and the StreamUpdate.committed deltas equal JAX's
    update by update, where an agreed prefix rewrites the committed text
    too (an earlier commit is not a prefix of a later one, and the
    deltas stop adding up to it)."""
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
    from qwen3_asr_rs_tpu.runtime.streaming import (
        StreamingTranscriber as JaxTranscriber,
    )

    cfg = _cfg(jconfig)
    jeng = JaxEngine(
        model_dir=None, dtype=jnp.float32, max_new_tokens=2,
        chunk_buckets=(2, 15), config=cfg,
        params=(init_encoder_params(cfg.audio, dtype=jnp.float32),
                init_decoder_params(cfg.text, dtype=jnp.float32,
                                    scale=VARIED)),
        tokenizer=_Tok())
    kw = dict(update_interval_s=2.0, max_stream_seconds=8.0,
              max_new_tokens=2, agreement=2)
    chunks = [(np.random.default_rng(0).standard_normal(32000 * 10) * 0.1)
              .astype(np.float32)[i * 32000:(i + 1) * 32000]
              for i in range(10)]

    def feed(stream):
        history, deltas = [""], []
        for c in chunks:
            deltas.append(stream.feed(c).committed)
            history.append(stream.committed_text)
        return history, deltas

    history, deltas = feed(JaxTranscriber(jeng, **kw))
    assert feed(StreamingTranscriber(_engine(max_new=2, scale=VARIED),
                                     **kw)) == (history, deltas)
    assert not all(b.startswith(a) for a, b in zip(history, history[1:]))
    assert "".join(deltas) != history[-1]
