# A copy of qwen3_asr_rs_tpu/runtime/longform.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Long-form transcription: overlapped segments with transcript stitching.

Audio longer than the largest compiled bucket is split into segments that
overlap by a couple of seconds; adjacent transcripts are merged at the
overlap by finding the best token-sequence join (longest common
contiguous word run inside the overlap region). This avoids both dropped
and duplicated words at segment boundaries — the failure mode of naive
chunking.

The reference handles long audio only through its windowed encoder (it
decodes any length in one pass, src/audio_encoder.rs:172-260); bucketed
compilation makes segmenting preferable here, and overlap-stitch keeps
boundary quality.
"""

from __future__ import annotations

import dataclasses
import logging
import re
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class Segment:
    """A time-stamped span of the final transcript.

    ``start``/``end`` are the audio times (seconds) of the decode
    segment that produced ``text``. Within an overlap junction the true
    boundary lies somewhere inside the ~2 s overlap, so timestamps are
    accurate to the overlap width — the right granularity for subtitle
    cues and seek links (the reference has no timestamp support at all;
    src/inference.rs:160-200 returns plain text)."""

    id: int
    start: float
    end: float
    text: str
    # per-word timings (list[Word]) — filled by attach_words(); None
    # until then so Segment stays cheap to construct in hot host code
    words: Optional[list] = None


@dataclasses.dataclass
class Word:
    """A single word (or CJK character) with its time span.

    Times come from length-proportional alignment within the parent
    segment's span (see word_timings) — the standard fallback
    granularity (Whisper uses the same when its aligner yields nothing).
    A cross-attention aligner is deliberately NOT used: the decode loop
    is one fused on-device while_loop, and extracting per-token
    attention maps would change (and slow) the production graph. The
    reference has no word or segment timestamps at all
    (src/inference.rs:160-200 returns plain text)."""

    word: str
    start: float
    end: float


def word_timings(text: str, start: float, end: float) -> list["Word"]:
    """Length-proportional word timings over [start, end].

    Words are the stitcher's join units (_split_units): whitespace-split
    runs for spaced scripts, single characters for CJK — so Chinese gets
    per-character times instead of one giant span. Each unit's duration
    is proportional to its character count; spans partition [start, end]
    contiguously (no gaps), which is what subtitle tooling expects.
    """
    units = _split_units(text)
    if not units:
        return []
    dur = max(end - start, 0.0)
    total = sum(len(u) for u, _ in units)
    out, acc = [], 0
    for u, _ in units:
        w_start = start + dur * acc / total
        acc += len(u)
        out.append(Word(u, round(w_start, 3),
                        round(start + dur * acc / total, 3)))
    return out


def attach_words(segments: Optional[list]) -> Optional[list]:
    """Fill each Segment's ``words`` in place (returns the list)."""
    for s in segments or []:
        s.words = word_timings(s.text, s.start, s.end)
    return segments


# Scripts written without inter-word spaces (CJK + fullwidth forms).
# str.split() on such text yields one giant "word" per segment, so no
# join is ever found and the overlap DUPLICATES (the reference's sample3
# fixture is Chinese); these
# characters therefore become single-character join units instead.
_CJK_RANGES = (
    "ᄀ-ᇿ"   # Hangul Jamo
    "⺀-〿"   # CJK radicals, Kangxi, CJK symbols & punctuation
    "぀-ヿ"   # Hiragana, Katakana
    "㄰-㆏"   # Hangul compatibility Jamo
    "ㇰ-ㇿ"   # Katakana phonetic extensions
    "㐀-䶿"   # CJK extension A
    "一-鿿"   # CJK unified ideographs
    "가-힯"   # Hangul syllables
    "豈-﫿"   # CJK compatibility ideographs
    "＀-･"   # fullwidth forms incl. ，！？
)
_CJK_RE = re.compile(f"[{_CJK_RANGES}]")
# a unit is one CJK character OR a maximal run of non-space non-CJK text.
# The (?!\s) guard keeps whitespace out of the units: U+3000 IDEOGRAPHIC
# SPACE falls inside the CJK-symbols range, and a space that counted as
# a join unit could satisfy best_join's 2-unit credible-match threshold
# and delete real text on a false join.
_UNIT_RE = re.compile(f"(?!\\s)[{_CJK_RANGES}]|[^\\s{_CJK_RANGES}]+")


def _split_units(text: str) -> list[tuple[str, int]]:
    """(unit, start_char_offset) list: CJK chars are single units,
    everything else splits on whitespace. Mixed-script text yields mixed
    units, so joins work across e.g. Chinese with Latin names inline."""
    return [(m.group(), m.start()) for m in _UNIT_RE.finditer(text)]


MAX_EDGE_NOISE = 2  # garbled units tolerated at a segment boundary


def best_join(prev_words: list[str], next_words: list[str],
              search: int = 30) -> tuple[int, int]:
    """Find the best (drop_from_prev_end, drop_from_next_start) join.

    Searches for the longest common contiguous unit run ANCHORED at the
    junction: the match must reach within MAX_EDGE_NOISE units of the
    previous segment's end and begin within MAX_EDGE_NOISE units of the
    next segment's start — that is where the audio overlap physically
    is. An unanchored search deletes real text on repetitive speech
    (e.g. prev ending in 30x 'yeah': the earliest 5-long match would
    drop all 30). Ties prefer the LATEST match in the tail (smallest
    deletion). Returns unit counts to trim from each side so the
    overlap region appears exactly once; (0, 0) when no credible
    (>= 2 contiguous units, anchored) match exists.
    """
    tail = prev_words[-search:]
    head = next_words[:search]
    best_key = None
    best = (0, 0)
    for i in range(len(tail)):
        for j in range(min(len(head), MAX_EDGE_NOISE + 1)):
            k = 0
            while (
                i + k < len(tail)
                and j + k < len(head)
                and tail[i + k] == head[j + k]
            ):
                k += 1
            if k >= 2 and len(tail) - (i + k) <= MAX_EDGE_NOISE:
                key = (k, i)  # longest run, then latest position
                if best_key is None or key > best_key:
                    best_key = key
                    # keep the overlap words from the next segment:
                    # drop the matched tail words (and trailing garble)
                    # from prev, drop the pre-match words from next
                    best = (len(tail) - i, j)
    return best


def _cut_pieces(pieces: list[tuple[int, str]],
                cut: int) -> list[tuple[int, str]]:
    """Truncate a (chunk_idx, text) piece list to ``cut`` total chars."""
    out: list[tuple[int, str]] = []
    pos = 0
    for idx, text in pieces:
        if pos + len(text) <= cut:
            out.append((idx, text))
            pos += len(text)
        else:
            keep = cut - pos
            if keep > 0:
                out.append((idx, text[:keep]))
            break
    return out


def stitch_spans(transcripts: list[str]) -> list[tuple[int, str]]:
    """Merge overlapped segment transcripts, tracking provenance.

    Returns a list of ``(chunk_idx, text)`` pieces whose concatenation
    is the stitched transcript; each piece records which input segment
    its text survived from, so callers can attach per-segment audio
    timestamps (see transcribe_long). ``stitch`` is this with the
    provenance dropped.
    """
    pieces: list[tuple[int, str]] = []
    merged = ""
    for i, nxt in enumerate(transcripts):
        if not merged:
            merged = nxt
            if nxt:
                pieces = [(i, nxt)]
            continue
        if not nxt:
            continue
        pu = _split_units(merged)
        nu = _split_units(nxt)
        drop_prev, drop_next = best_join(
            [u for u, _ in pu], [u for u, _ in nu]
        )
        if drop_prev:
            # cut both strings at the matched overlap: drop the match
            # (and trailing garble) from prev, keep it from next
            cut = pu[len(pu) - drop_prev][1]
            start = nu[drop_next][1] if drop_next < len(nu) else len(nxt)
            pieces = _cut_pieces(pieces, cut)
            if nxt[start:]:
                pieces.append((i, nxt[start:]))
            merged = merged[:cut] + nxt[start:]
        else:
            # no credible overlap: append, with a space only where the
            # boundary scripts use one
            lead = nxt.lstrip()
            sep = (
                ""
                if (merged[-1].isspace() or nxt[0].isspace()
                    or _CJK_RE.match(merged[-1]) or _CJK_RE.match(lead[:1]))
                else " "
            )
            pieces.append((i, sep + nxt))
            merged = merged + sep + nxt
    return pieces


def stitch(transcripts: list[str]) -> str:
    """Merge overlapped segment transcripts into one.

    Join units are whitespace words for spaced scripts and single
    characters for CJK (see _split_units), and the merge cuts the
    ORIGINAL strings at unit offsets, so the surviving text keeps its
    exact spacing (e.g. Chinese with spaced Latin names inline).
    """
    return "".join(t for _, t in stitch_spans(transcripts))


# Budget for batched long-form decode: batch_size * bucket_chunks is
# capped so the batched KV slab stays within a few GB of HBM even at
# the 360 s bucket (960 == 8 concurrent 120 s segments).
LONGFORM_BATCH_BUDGET_CHUNKS = 960


def transcribe_long(
    engine,
    samples: np.ndarray,
    language: Optional[str] = None,
    segment_seconds: Optional[float] = None,
    overlap_seconds: float = 2.0,
    sample_rate: int = 16000,
    batch_chunks: int = 8,
):
    """Overlapped segmentation + stitching over an AsrEngine.

    Segments are decoded in BATCHES of up to ``batch_chunks`` through
    engine.transcribe_batch — the decode weight stream amortizes across
    concurrent segments (measured ~2x aggregate at batch 8), so a long
    file transcribes much faster than the reference's one-pass
    sequential decode. ``batch_chunks=1`` restores sequential decoding;
    the effective batch is clamped so batch x segment-length stays
    within LONGFORM_BATCH_BUDGET_CHUNKS (KV-slab HBM budget).

    The result carries ``segments``: time-stamped spans of the final
    transcript (one per surviving chunk contribution, accurate to the
    overlap width).
    """
    from .engine import TranscribeResult

    max_seconds = segment_seconds or engine.max_bucket_seconds
    seg = int(max_seconds * sample_rate)
    overlap = int(min(overlap_seconds, max_seconds / 4) * sample_rate)
    step = seg - overlap

    starts: list[int] = []
    start = 0
    while start < len(samples):
        if len(samples) - start < 400:
            break
        starts.append(start)
        if start + seg >= len(samples):
            break
        start += step
    chunks = [samples[s : s + seg] for s in starts]

    # HBM clamp must reflect what actually runs on device: transcribe_batch
    # rounds the batch UP to the next power of two (and a dp multiple) and
    # compiles the next-LARGER chunk bucket, so clamping on
    # ceil(segment_seconds) could admit a padded batch x bucket product 2x
    # the budget (e.g. segment_seconds=121 -> batch 7 -> padded 8 on a
    # 240-chunk bucket). Clamp on the compiled bucket and round DOWN.
    from ..features.mel import num_mel_frames

    try:
        bucket_chunks = engine._pick_bucket(num_mel_frames(seg))
    except ValueError:  # segment fills the largest bucket exactly
        bucket_chunks = engine.chunk_buckets[-1]
    batch = max(1, min(batch_chunks,
                       LONGFORM_BATCH_BUDGET_CHUNKS // bucket_chunks))
    batch = 1 << (batch.bit_length() - 1)  # round DOWN to a power of two
    dp = getattr(engine, "_dp_size", lambda: 1)()
    if dp > 1:
        # keep the padded device batch == batch (transcribe_batch pads up
        # to a dp multiple; dp itself is the floor a mesh user chose)
        batch = max(batch - batch % dp, dp)
    if batch > 1 and len(chunks) > 1:
        results = []
        for i in range(0, len(chunks), batch):
            group = chunks[i : i + batch]
            results.extend(
                engine.transcribe_batch(group, [language] * len(group))
            )
    else:
        results = [engine.transcribe_samples(c, language) for c in chunks]

    texts = [r.text for r in results]
    langs = [r.language for r in results]
    raws = [r.raw_output for r in results]
    logger.info("long-form: %d segments stitched (batch %d)",
                len(texts), batch)
    spans = stitch_spans(texts)
    segments = [
        Segment(
            id=k,
            start=starts[idx] / sample_rate,
            end=min(starts[idx] + seg, len(samples)) / sample_rate,
            text=text,
        )
        for k, (idx, text) in enumerate(spans)
        if text  # pieces are non-empty by construction; keep segments an
        # exact partition: "".join(s.text) == result.text
    ]
    # Adjacent decode segments overlap by ~overlap_seconds; emitting the
    # raw spans would give consecutive subtitle cues overlapping time
    # ranges (breaks some SRT/VTT tooling). Clip each span's end to the
    # next span's start so cues are non-overlapping; the text partition
    # is untouched and accuracy stays at the overlap width.
    for a, b in zip(segments, segments[1:]):
        a.end = max(a.start, min(a.end, b.start))
    attach_words(segments)
    return TranscribeResult(
        text="".join(t for _, t in spans),
        language=langs[0] if langs else "unknown",
        raw_output="\n".join(raws),
        segments=segments,
    )
