"""Streaming (incremental) transcription with KV and encoder reuse.

Port of ``qwen3_asr_rs_tpu/runtime/streaming.py``. Qwen3-ASR is not a
streaming model, but two of its structures make incremental work exact:

  * the encoder attends within 8-chunk (8 s) windows only, so a completed
    window's embeddings never change as audio grows: ``StreamingSession``
    encodes each window once and keeps the result;
  * decoder attention is causal, so the slab rows of the prompt header and
    of completed windows' audio tokens never change:
    ``TextDecoder.prefill_chunk`` extends a persistent slab with the
    changed suffix only (the partial tail window and the prompt tail).

An update therefore encodes at most 2 windows (a newly completed one and
the tail), prefills one chunk of 128 * 2^j positions, and re-decodes
greedily from it. The log-mel floor is ``max - 8`` of a global max: the
session keeps a running max over the audio seen (``raw_log_mel_max``)
and encodes every window with it; a max that rises past the max the
cached windows were encoded with by more than ``MAX_TOLERANCE``
re-encodes them. ``StreamingTranscriber`` commits text by LocalAgreement
(the common prefix of the last hypotheses), rolls over to a fresh
session with ~2 s of overlap audio before an update would outgrow the
slab (stitched with ``longform.stitch``), and ``finalize()`` runs the
offline engine over the current session's audio.

Committed text follows JAX's rule. An agreed prefix longer than the
committed text is committed, and at a rollover the finished session's
final hypothesis (stitched to the rolled text) is committed, even where
either does not extend the committed text, which then changes. The
``StreamUpdate.committed`` deltas are formed as JAX forms them (the
rolled text past the old committed length, then the agreed prefix past
it), so where the committed text is rewritten they no longer add up to
``committed_text``; between rewrites they do.

Who owns the slab and the graph. The re-decode after each chunk is the
greedy B = 1 loop (K1 per step); on CUDA each step replays a captured
CUDA graph, which reads and writes fixed addresses. The slabs, the
decode state and the graphs are therefore owned by ``_StreamGraphs``,
one per (engine, slab length, max_new_tokens), as a pool of leases
(``_StreamSlab``: a bf16 slab in the engine's dtype, whatever
``kv_dtype`` says, as in JAX; a ``_DecodeState``; the step's graph,
captured at the lease's first decoding update). A session leases one
for its lifetime and gives it back when it is closed or collected; the
transcriber closes the finished session before it opens the next at a
rollover, which takes the same lease back, so a rollover captures
nothing. Two sessions alive at once hold two leases, each with its own
slab, state and graph: neither sees the other's tokens. A new lease's
slab is not cleared: a session writes slots [0, n) before any mask makes
them attendable.

On an engine's device mesh every rank runs the same session (SPMD); under
tp the decoder and slab are the rank's shard and the steps run eagerly.
"""

from __future__ import annotations

import dataclasses
import logging
import weakref
from typing import Optional

import numpy as np
import torch

from ..config import audio_tokens
from ..features.mel import log_mel_from_padded, num_mel_frames, raw_log_mel_max
from ..models.decoders import require
from ..models.text_decoder import KVCache, TextDecoder
from .cuda_graph import StepGraph, capture
from .engine import AsrEngine, TranscribeResult, _DecodeState, _DoneFlags
from .prompt import AUDIO_OFFSET, build_prompt, parse_asr_output
from .sampling import SamplingParams

logger = logging.getLogger(__name__)

HOP = 160
N_FFT = 400
SAMPLE_RATE = 16000


@dataclasses.dataclass
class StreamUpdate:
    committed: str       # newly committed (stable) text this update
    hypothesis: str      # current full hypothesis (may still change)
    audio_seconds: float


def common_prefix_len(texts: list[str]) -> int:
    if not texts:
        return 0
    shortest = min(len(t) for t in texts)
    i = 0
    while i < shortest and all(t[i] == texts[0][i] for t in texts):
        i += 1
    return i


# ---------------------------------------------------------------------- #
# per-engine device state: window encode, chunk step, slab leases
# ---------------------------------------------------------------------- #


@dataclasses.dataclass
class _StreamSlab:
    """One lease: a session's slab, its decode state and its captured
    decode step (None until its first decoding update on CUDA)."""

    cache: KVCache
    state: _DecodeState
    graph: Optional[StepGraph] = None


class _StreamGraphs:
    """The streaming device paths of one engine at one slab length and
    token cap (JAX ``_StreamGraphs``): the window encode, the chunk step,
    and the pool of slab leases with their graphs (see the module
    docstring). ``captures`` and ``replays`` count the decode graphs'."""

    def __init__(self, engine: AsrEngine, s_stream: int, max_new: int):
        self.engine = engine
        self.s_stream = s_stream
        self.max_new = max_new
        self.decoder = TextDecoder(engine.config.text,
                                   max_position=s_stream + 8,
                                   device=engine.device, tp=engine._tp)
        self._free: list[_StreamSlab] = []
        self.leases = 0   # leases made (each with its own slab)
        self.captures = self.replays = 0
        self._side = self._pool = None

    def window_encode(self, wave, n_frames: int, log_max: float):
        """Encoder embeddings (window tokens, H) of one window's padded
        wave, its log-mel floored at ``log_max - 8``."""
        eng = self.engine
        mel = log_mel_from_padded(wave, n_frames, eng.mel_filters,
                                  log_max=torch.tensor(log_max,
                                                       device=wave.device))
        embeds, _ = eng.encoder(eng.enc_params, mel, n_frames)
        return embeds

    def raw_max(self, wave, n_frames: int) -> float:
        return float(raw_log_mel_max(wave, n_frames, self.engine.mel_filters))

    # ---- leases -------------------------------------------------------

    def lease(self) -> _StreamSlab:
        """A free slab lease, or a new one."""
        if self._free:
            return self._free.pop()
        eng = self.engine
        self.leases += 1
        return _StreamSlab(
            cache=KVCache.zeros(self.decoder.cfg, 1, self.s_stream,
                                dtype=eng.dtype, device=eng.device),
            state=_DecodeState.zeros(1, self.max_new, eng.device,
                                     self.decoder))

    def release(self, slab: _StreamSlab) -> None:
        self._free.append(slab)

    # ---- the chunk step -------------------------------------------------

    def _hidden_from_chunk(self, audio_embeds, token_ids, audio_rel_start,
                           n_audio_chunk):
        """Chunk embeddings with chunk slot i taking audio embedding i -
        ``audio_rel_start`` where that lies in [0, ``n_audio_chunk``)."""
        eng = self.engine
        tok = self.decoder.embed(eng.dec_params, token_ids[None])
        rel = torch.arange(token_ids.shape[0],
                           device=token_ids.device) - audio_rel_start
        is_audio = (rel >= 0) & (rel < n_audio_chunk)
        idx = torch.clamp(rel, 0, audio_embeds.shape[0] - 1)
        gathered = audio_embeds[idx][None].to(tok.dtype)
        return torch.where(is_audio[None, :, None], gathered, tok)

    def chunk_step(self, do_decode: bool, p_bucket: int):
        """The chunk prefill (+ the greedy decode) over a lease's slab, for
        chunks padded to ``p_bucket`` = 128 * 2^j ids (JAX's jitted
        ``chunk_step``). The returned function takes (slab lease, audio
        embeddings, ids (p_bucket,), audio_rel_start, n_audio_chunk,
        true_chunk, start) and returns the decoded token ids (EOS
        excluded; [] without ``do_decode``)."""

        @torch.inference_mode()
        def fn(slab: _StreamSlab, audio_embeds, token_ids, audio_rel_start,
               n_audio_chunk, true_chunk, start):
            assert token_ids.shape[0] == p_bucket
            eng = self.engine
            hidden = self._hidden_from_chunk(audio_embeds, token_ids,
                                             audio_rel_start, n_audio_chunk)
            logits, _ = self.decoder.prefill_chunk(
                eng.dec_params, hidden, start, slab.cache, true_chunk)
            if not do_decode:
                return []
            return self._decode(slab, logits, start + true_chunk)

        return fn

    def _decode(self, slab: _StreamSlab, logits, pos0: int) -> list[int]:
        """The greedy loop from the chunk's logits (JAX's streaming body):
        the argmax token 0, then decode steps at slot pos0 + step until an
        EOS or max_new tokens, on device state; on CUDA the lease's
        captured step is replayed in chunks of the engine's
        ``decode_chunk``, with one non-blocking read of the done flag
        each."""
        eng = self.engine
        st, cache = slab.state, slab.cache
        st.start(np.ones(1, bool), pos0, SamplingParams())
        st.append(torch.argmax(logits, dim=-1))
        dec, params = self.decoder, eng.dec_params

        def step():
            tok, _ = dec.decode_step_token(params, st.tok, st.base + st.step,
                                           cache)
            st.append(tok)
            st.step.add_(1)

        total = self.max_new - 1
        steps = 0
        run = step
        # a tp step runs eagerly: its collectives are not captured
        if eng.device.type == "cuda" and eng.cuda_graphs and eng._tp is None:
            if slab.graph is None:
                slab.graph = self._capture(step)
                self.captures += 1
                steps = 1
            run = slab.graph.replay
        flags = _DoneFlags(eng.device)
        pending = None
        while steps < total:
            n = min(eng.decode_chunk, total - steps)
            for _ in range(n):
                run()
            steps += n
            if run is not step:
                self.replays += n
            posted = flags.post(st.done)
            if pending is not None and flags.read(pending):
                break
            pending = posted
        n_gen = int(st.n_gen[0])
        return st.out_buf[0, :n_gen].tolist()

    def _capture(self, fn) -> StepGraph:
        """Run ``fn`` once eagerly on this object's capture stream, then
        capture it into this object's graph memory pool."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.engine.device)
            self._pool = torch.cuda.graph_pool_handle()
        return capture(fn, self._side, self._pool)


def _stream_graphs(engine: AsrEngine, s_stream: int,
                   max_new: int) -> _StreamGraphs:
    cache = engine._stream_graphs
    key = (s_stream, max_new)
    if key not in cache:
        cache[key] = _StreamGraphs(engine, s_stream, max_new)
    return cache[key]


# ---------------------------------------------------------------------- #
# the incremental session
# ---------------------------------------------------------------------- #


class StreamingSession:
    """Incremental transcription state over a growing audio buffer.

    Holds a slab lease, the per-window encoder cache and the running mel
    max. ``update()`` ingests whatever audio is in ``self.buffer`` and
    returns the current hypothesis. ``close()`` gives the lease back (so
    does garbage collection); a closed session may not update again.
    """

    # re-encode cached windows when the running mel max rises by more
    # than this (log10 units); below it the floor shift is inaudible
    MAX_TOLERANCE = 0.5

    def __init__(
        self,
        engine: AsrEngine,
        language: Optional[str] = None,
        max_stream_seconds: float = 120.0,
        max_new_tokens: int = 256,
    ):
        require(engine.config.text, "streaming")
        self.engine = engine
        self.language = language
        acfg = engine.config.audio
        self.cf = acfg.chunk_frames
        self.cpw = acfg.chunks_per_window
        self.tpc = acfg.tokens_per_chunk
        self.window_frames = self.cpw * self.cf
        self.window_samples = self.window_frames * HOP
        self.window_tokens = self.cpw * self.tpc

        max_chunks = int(np.ceil(max_stream_seconds * SAMPLE_RATE
                                 / (self.cf * HOP)))
        n_audio_max = max_chunks * self.tpc
        s = AUDIO_OFFSET + n_audio_max + 32 + max_new_tokens + 8
        self.s_stream = -(-s // 128) * 128
        self.max_samples = max_chunks * self.cf * HOP
        self.max_new = max_new_tokens

        self.graphs = _stream_graphs(engine, self.s_stream, max_new_tokens)
        self._slab = self.graphs.lease()
        self._finalizer = weakref.finalize(self, self.graphs.release,
                                           self._slab)
        self.buffer = np.zeros(0, np.float32)
        self.win_embeds: list = []   # device (window_tokens, H) per window
        self.kv_windows = 0          # windows whose KV rows are committed
        self.session_max = -np.inf   # running raw log10-mel max
        # the mel max the cached windows were encoded with: invalidation
        # compares against THIS, not the running max, so that a gradual
        # rise cannot ratchet past the tolerance unnoticed
        self.encode_max = -np.inf
        self._win_max: dict[int, float] = {}  # per-window raw max
        # (wave, n_frames) built this update: the raw-max scan and the
        # encode share one host build and one copy to the device
        self._wave_cache: dict[int, tuple] = {}
        self._zero_embeds = None
        self.last_update_stats: dict = {}

    def close(self) -> None:
        """Give the slab lease back to the engine's pool."""
        self._finalizer()

    # -------------------------------------------------------------- #

    @property
    def kv_len(self) -> int:
        return (AUDIO_OFFSET + self.kv_windows * self.window_tokens
                if self.kv_windows > 0 else 0)

    @property
    def full(self) -> bool:
        return len(self.buffer) >= self.max_samples

    def _window_wave(self, w: int, usable_len: int) -> tuple[np.ndarray, int]:
        """The padded wave of window ``w`` with exact mel context, as
        ``pad_waveform`` gives it over the whole buffer: real left context
        (a start reflect for window 0), real right context for a completed
        window, the hop pad and an end reflect for the tail window."""
        pad = N_FFT // 2
        start = w * self.window_samples
        end = min(usable_len, start + self.window_samples)
        total = self.window_samples + 2 * pad
        wave = np.zeros(total, np.float32)

        seg = self.buffer[start:end]
        n_frames = num_mel_frames(len(seg), HOP)
        hop_len = n_frames * HOP
        body = np.zeros(hop_len, np.float32)
        body[: len(seg)] = seg

        if w == 0:
            wave[:pad] = self.buffer[pad:0:-1][:pad]
        else:
            wave[:pad] = self.buffer[start - pad: start]
        wave[pad: pad + hop_len] = body

        right = self.buffer[end: end + pad]
        if len(right) >= 40 and len(seg) == self.window_samples:
            # completed window: real right context (frames peek <= 40
            # samples past the window end)
            wave[pad + hop_len: pad + hop_len + len(right)] = right
        else:
            # tail window: the end reflect of the whole buffer's hop-padded
            # wave (for tiny tails the mirror reaches the previous window)
            gidx = start + hop_len - 2 - np.arange(pad)
            ok = (gidx >= 0) & (gidx < usable_len)
            vals = np.where(
                ok, self.buffer[np.clip(gidx, 0, max(0, usable_len - 1))],
                0.0)
            wave[pad + hop_len: pad + hop_len + pad] = vals
        return wave, n_frames

    def _cached_wave(self, w: int, usable_len: int):
        if w not in self._wave_cache:
            wave, n_frames = self._window_wave(w, usable_len)
            self._wave_cache[w] = (
                torch.from_numpy(wave).to(self.engine.device), n_frames)
        return self._wave_cache[w]

    def _encode_window(self, w: int, usable_len: int):
        wave, n_frames = self._cached_wave(w, usable_len)
        with torch.inference_mode():
            return self.graphs.window_encode(wave, n_frames, self.session_max)

    def _update_running_max(self, usable_len: int) -> bool:
        """Scan new and changed windows for the raw mel max. Returns True
        if the max rose past the cached windows' encode-time max by more
        than the tolerance (they must be encoded again)."""
        n_total = num_mel_frames(usable_len, HOP)
        last_w = (n_total - 1) // self.window_frames
        for w in range(len(self.win_embeds), last_w + 1):
            wave, n_frames = self._cached_wave(w, usable_len)
            with torch.inference_mode():
                self._win_max[w] = self.graphs.raw_max(wave, n_frames)
        new_max = max(self._win_max.values(), default=-np.inf)
        rose = (np.isfinite(new_max) and np.isfinite(self.encode_max)
                and new_max > self.encode_max + self.MAX_TOLERANCE)
        if new_max > self.session_max:
            self.session_max = new_max
        return rose and len(self.win_embeds) > 0

    def _chunk_dispatch(self, do_decode: bool, audio_embeds, chunk_ids,
                        audio_rel_start, n_audio_chunk) -> list[int]:
        true_chunk = len(chunk_ids)
        p_bucket = 128
        while p_bucket < true_chunk:
            p_bucket *= 2
        ids = torch.zeros(p_bucket, dtype=torch.long)
        ids[:true_chunk] = torch.tensor(chunk_ids)
        fn = self.graphs.chunk_step(do_decode, p_bucket)
        return fn(self._slab, audio_embeds, ids.to(self.engine.device),
                  audio_rel_start, n_audio_chunk, true_chunk, self.kv_len)

    def update(self) -> TranscribeResult:
        """Ingest the buffer incrementally; returns the current
        hypothesis. Fills ``last_update_stats`` (JAX's: windows encoded,
        chunk positions, decoded tokens)."""
        assert self._finalizer.alive, "the session is closed"
        assert len(self.buffer) >= N_FFT, "need at least one mel frame"
        assert len(self.buffer) <= self.max_samples, (
            "buffer exceeds session capacity; the transcriber must roll "
            "over BEFORE updating (positions past the slab fail)")
        stats = {"windows_encoded": 0, "chunk_positions": 0}
        self._wave_cache = {}

        # windows are cacheable once their right mel context (40 samples)
        # has arrived; audio past the last full-or-partial window waits
        w_cacheable = 0
        while ((w_cacheable + 1) * self.window_samples + 40
               <= len(self.buffer)):
            w_cacheable += 1
        usable_len = min(len(self.buffer),
                         (w_cacheable + 1) * self.window_samples)
        n_total_frames = num_mel_frames(usable_len, HOP)

        if self._update_running_max(usable_len):
            logger.info("stream: mel max rose beyond tolerance; re-encoding "
                        "%d cached windows", len(self.win_embeds))
            self.win_embeds = []
            self.kv_windows = 0
        if not self.win_embeds:
            # the floor base of whatever gets cached from here on
            self.encode_max = self.session_max

        # encode newly completed windows
        while len(self.win_embeds) < w_cacheable:
            w = len(self.win_embeds)
            self.win_embeds.append(self._encode_window(w, usable_len))
            stats["windows_encoded"] += 1

        # the tail (partial) window, encoded again every update
        tail_frames = n_total_frames - w_cacheable * self.window_frames
        tail_embeds = None
        tail_valid = 0
        if tail_frames > 0:
            tail_embeds = self._encode_window(w_cacheable, usable_len)
            stats["windows_encoded"] += 1
            tail_valid = audio_tokens(self.engine.config.audio,
                                      tail_frames)

        n_audio = w_cacheable * self.window_tokens + tail_valid
        prompt = build_prompt(n_audio, self.language, self.engine.tokenizer)

        if self._zero_embeds is None:
            h = self.engine.config.audio.output_dim
            self._zero_embeds = torch.zeros(
                (self.window_tokens, h), dtype=self.engine.dtype,
                device=self.engine.device)

        # catch-up: commit all but one pending completed window with
        # prefill-only chunks (one window each; large feeds)
        while w_cacheable - self.kv_windows > 1:
            w = self.kv_windows
            kv_len = self.kv_len
            p_start = AUDIO_OFFSET + w * self.window_tokens
            chunk_ids = prompt[kv_len: p_start + self.window_tokens]
            src = torch.cat([self.win_embeds[w].to(self.engine.dtype),
                             self._zero_embeds])
            self._chunk_dispatch(False, src, chunk_ids,
                                 audio_rel_start=max(0, AUDIO_OFFSET - kv_len),
                                 n_audio_chunk=self.window_tokens)
            stats["chunk_positions"] += len(chunk_ids)
            self.kv_windows = w + 1

        # final chunk: (maybe one new window) + tail audio + prompt tail
        kv_len = self.kv_len
        chunk_ids = prompt[kv_len:]
        new_w = w_cacheable - self.kv_windows  # 0 or 1
        tail_src = (tail_embeds.to(self.engine.dtype)
                    if tail_embeds is not None else self._zero_embeds)
        if new_w:
            src = torch.cat([self.win_embeds[self.kv_windows].to(
                self.engine.dtype), tail_src])
        else:
            src = torch.cat([tail_src, self._zero_embeds])
        generated = self._chunk_dispatch(
            True, src, chunk_ids,
            audio_rel_start=max(0, AUDIO_OFFSET - kv_len),
            n_audio_chunk=new_w * self.window_tokens + tail_valid)
        stats["chunk_positions"] += len(chunk_ids)
        self.kv_windows = w_cacheable

        raw = self.engine.tokenizer.decode(generated)
        lang, text = parse_asr_output(raw, self.language is not None)
        stats["decoded_tokens"] = len(generated)
        self.last_update_stats = stats
        return TranscribeResult(text=text, language=lang, raw_output=raw)


# ---------------------------------------------------------------------- #
# the public transcriber (LocalAgreement commits, session rollover)
# ---------------------------------------------------------------------- #


class StreamingTranscriber:
    """An incremental transcription over an AsrEngine."""

    def __init__(
        self,
        engine: AsrEngine,
        language: Optional[str] = None,
        update_interval_s: float = 1.0,
        agreement: int = 2,
        sample_rate: int = SAMPLE_RATE,
        max_stream_seconds: Optional[float] = None,
        max_new_tokens: Optional[int] = None,
        rollover_overlap_s: float = 2.0,
    ):
        require(engine.config.text, "streaming")
        self.engine = engine
        self.language = language
        self.update_interval = int(update_interval_s * sample_rate)
        self.agreement = max(1, agreement)
        self.sample_rate = sample_rate
        if max_stream_seconds is None:
            max_stream_seconds = min(engine.max_bucket_seconds, 120.0)
        if max_new_tokens is None:
            max_new_tokens = min(engine.max_new_tokens, 256)
        self._session_args = dict(
            language=language,
            max_stream_seconds=max_stream_seconds,
            max_new_tokens=max_new_tokens,
        )
        self.rollover_overlap = int(rollover_overlap_s * sample_rate)
        self.session = StreamingSession(engine, **self._session_args)
        self._since_update = 0
        # feed() appends here; the buffer concatenates once per update
        self._pending: list[np.ndarray] = []
        self._pending_len = 0
        self._hypotheses: list[str] = []
        self._rolled = ""       # text committed by completed sessions
        self._committed = ""    # total committed text (incl. rolled)
        self._overlap_carried = False  # rolled text overlaps session head
        self._last_result: Optional[TranscribeResult] = None

    @property
    def committed_text(self) -> str:
        return self._committed

    def feed(self, samples: np.ndarray) -> Optional[StreamUpdate]:
        """Add audio; returns an update when a re-transcription ran."""
        samples = np.asarray(samples, np.float32).reshape(-1)
        self._pending.append(samples)
        self._pending_len += len(samples)
        self._since_update += len(samples)
        if self._since_update < self.update_interval:
            return None
        self._since_update = 0
        self._flush()
        return self._update()

    def _flush(self) -> None:
        if self._pending:
            self.session.buffer = np.concatenate(
                [self.session.buffer, *self._pending])
            self._pending = []
            self._pending_len = 0

    def _seconds(self) -> float:
        return (len(self.session.buffer) + self._pending_len) / (
            self.sample_rate)

    def _join(self, text: str) -> str:
        """Rolled text + the current session's text; after a rollover the
        session's buffer starts with ``rollover_overlap`` seconds that the
        rolled text covers, so the junction is stitched
        (``longform.stitch``) and boundary words appear once."""
        if not self._rolled:
            return text
        if self._overlap_carried and text:
            from .longform import stitch

            return stitch([self._rolled, text])
        return self._rolled + text

    def _update(self) -> StreamUpdate:
        if len(self.session.buffer) < N_FFT:
            return StreamUpdate("", self._committed, self._seconds())
        prev_committed = self._committed
        newly_rolled = ""
        # roll over BEFORE updating when the buffer exceeds the session's
        # capacity (positions past the slab); loops for feeds larger than
        # a whole session
        while len(self.session.buffer) > self.session.max_samples:
            buf = self.session.buffer
            ws = self.session.window_samples
            cut = (self.session.max_samples // ws) * ws
            if cut <= 0:
                cut = self.session.max_samples
            remainder = buf[cut:]
            self.session.buffer = buf[:cut]
            logger.info("stream: session capacity reached; rolling over "
                        "with %.1fs overlap",
                        self.rollover_overlap / self.sample_rate)
            final = self.session.update()
            hyp = self._join(final.text)
            self._rolled = hyp
            self._committed = hyp
            self._hypotheses = []
            overlap = buf[max(0, cut - self.rollover_overlap):cut]
            if len(overlap) >= cut:
                # a degenerate tiny session: carrying all of it forward
                # would never shrink the buffer
                overlap = overlap[:0]
            self._overlap_carried = len(overlap) > 0
            # the finished session's lease goes back first: the new
            # session takes it, with its captured decode step
            self.session.close()
            self.session = StreamingSession(self.engine,
                                            **self._session_args)
            self.session.buffer = np.concatenate([overlap, remainder])
        if len(self._committed) > len(prev_committed):
            newly_rolled = self._committed[len(prev_committed):]

        if len(self.session.buffer) < N_FFT:
            return StreamUpdate(newly_rolled, self._committed,
                                self._seconds())
        result = self.session.update()
        self._last_result = result
        hyp = self._join(result.text)
        self._hypotheses.append(hyp)

        newly = newly_rolled
        if len(self._hypotheses) >= self.agreement:
            window = self._hypotheses[-self.agreement:]
            stable = common_prefix_len(window)
            if stable > len(self._committed):
                newly += self._hypotheses[-1][len(self._committed):stable]
                self._committed = self._hypotheses[-1][:stable]
        logger.debug("stream update: %.1fs audio, hyp %r, committed %r",
                     self._seconds(), hyp, self._committed)
        return StreamUpdate(committed=newly, hypothesis=hyp,
                            audio_seconds=self._seconds())

    def finalize(self) -> TranscribeResult:
        """A final pass of the offline engine over the current session's
        audio (equal to the offline transcription when no rollover
        occurred)."""
        self._flush()
        buffer = self.session.buffer
        if len(buffer) < N_FFT:
            return TranscribeResult(text=self._committed, language="unknown",
                                    raw_output="")
        if len(buffer) <= self.engine.max_bucket_seconds * self.sample_rate:
            result = self.engine.transcribe_samples(buffer, self.language)
        else:
            from .longform import transcribe_long

            result = transcribe_long(self.engine, buffer, self.language)
        if self._rolled:
            result = TranscribeResult(text=self._join(result.text),
                                      language=result.language,
                                      raw_output=result.raw_output)
        self._committed = result.text
        self._last_result = result
        return result
