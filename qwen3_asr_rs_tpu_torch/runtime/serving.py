"""Continuous batching: the serving scheduler, in PyTorch.

Port of ``qwen3_asr_rs_tpu/runtime/serving.py``. The offline engine's
batch holds every utterance until the whole batch is
done and admits nothing mid-flight; this scheduler keeps a fixed pool of
decode slots over one shared KV slab instead:

  * decode runs in SEGMENTS of ``segment_steps`` steps over every slot,
    each slot at its own position (``TextDecoder.decode_step`` with a
    (B,) ``pos``: K2 at each row's own end); between segments the host
    reads the slots' done flags, returns finished requests at once and
    admits queued requests into free slots;
  * admission (mel -> encoder -> prompt injection -> prefill) writes a
    request's K/V into its slot's rows of the slab. Same-bucket requests
    queued at one scheduler step are admitted in one batched prefill,
    padded to a power of two by repeating row 0 (slot included);
  * long prompts (over ``prefill_chunk_tokens``) are prefilled in chunks
    (``TextDecoder.prefill_chunk``) into a per-admission cache, one chunk
    per scheduler step between decode segments, then committed to the
    slab; clips spanning several encoder window groups are also encoded
    one group per step;
  * ``serving_precision`` picks the decode weights per segment: the
    engine's, bf16, an int8 copy (``lm_bits=8``), or "auto" (int8 up to
    ``ASR_SERVING_INT8_MAX_OCC`` live slots, bf16 above). The copy works
    under tp too: JAX's unmerged copy, each rank quantizing its own
    pieces (``quantize_decoder_params(tp=)``), bit-equal to the whole
    weights quantized, then sharded;
  * greedy, sampled (temperature) and nucleus (per-request top_p)
    requests share the segments: a segment runs the variant the live
    requests need.

The decode state lives on the device at fixed addresses: pending token,
position, done flag, temperature, top_p, tokens emitted and token cap per
slot, the pool's PRNG key and the segment's (slots, steps) token buffer.
Admissions, ``_set_slot_state`` and ``_finish`` write into these tensors
in place, on the stream, before the next segment is enqueued. On CUDA
each (variant, precision) segment is one CUDA graph of ``segment_steps``
steps (``runtime/cuda_graph.py::StepGraph``: the first segment of a kind
runs eagerly on the capture stream, then is captured; later ones replay
it). Segments are pipelined: segment k + 1 is enqueued before segment
k's outputs are read. Each segment's outputs are copied into a ring of
two pinned host buffers with an event, and the host drains from that
ring (a replay overwrites the graph's own buffers).

Sampled draws are JAX's (``ops/prng.py``): the pool keeps one key chain
from ``prng_key(ASR_SAMPLING_SEED)``; each step of a sampled or nucleus
segment splits it (``key, sub = split(key)``, inside the draw kernel)
and draws over the whole (slots, V) logits with ``sub``, each slot at its
row; greedy segments leave it alone. Each admission (a monolithic or
batched prefill, and each chunk of a chunked one) takes ``fold_in(base,
n)`` for its n-th key, a batched admission's rows drawing at their rows
of the padded batch. So, as in JAX, a sampled request's tokens depend on
its slot and on the sampled steps the pool ran before it.

Differences from the JAX scheduler, none of which changes a transcript:
each slot also carries its token cap on the device and stops at it (JAX
decodes past the cap until the host's next drain and drops the extra
tokens), so no slot ever writes past ``prompt bucket + max_new`` and the
slab needs no 8/128 alignment (a Mosaic artifact); mel and the encoder
loop over a batch's clips; admissions run eagerly (once per request: no
graph). With a batcher on
the engine, the engine's kept first-stage slabs and graphs are freed:
the batcher owns its slab.

On a device mesh (the engine's ``mesh``; one whose axes are all 1 is no
mesh) the pool is SPMD over the mesh's ranks, each running this
scheduler on a mirror of the host state. The lead rank (0, 0) owns the
queue: each scheduler step it takes the requests to admit and broadcasts
them (and a stop request), so that every rank makes the same admissions,
retirements and segment choices. Slots shard over dp (the pool rounds up
to a multiple of dp): a rank holds the slab rows and device state of its
``n_slots / dp`` slots and does the admission work of those slots only.
Under tp every rank holds its KV heads of every slot, and the segments
run eagerly (their collectives are not captured). Each segment's outputs
reach every rank by one all-gather over dp. Requests are submitted on
the lead rank; ``drive`` submits and steps SPMD.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import queue
import threading
import time
from typing import Optional

import numpy as np
import torch

from ..config import audio_tokens
from ..features.mel import log_mel_from_padded, num_mel_frames, pad_waveform
from ..models.decoders import require
from ..models.text_decoder import KVCache, TextDecoder
from ..parallel.comm import all_gather, broadcast_from_lead, is_lead
from ..tokenizer import ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID
from .cuda_graph import StepGraph, capture
from ..ops.prng import KeyChain, prng_key
from .engine import AsrEngine, TranscribeResult
from .prompt import AUDIO_OFFSET, build_prompt, parse_asr_output
from .sampling import sample_token

logger = logging.getLogger(__name__)

PAD_TOKEN = -1  # out-buffer filler (never a valid token id)


def _write_slot_rows(slab: KVCache, tmp: KVCache, slots) -> None:
    """Copy row i of an admission cache into slab slot ``slots[i]``, in
    order, in place (scales too when the pool is int8): duplicate slots
    (batch padding repeats a real row, slot included) receive identical
    data. ``tmp`` may be longer than the slab (chunked prefill pads the
    prompt to the chunk size): the overhang holds no prompt position and
    is dropped."""
    p_keep = min(tmp.max_len, slab.max_len)
    pairs = [(slab.k, tmp.k), (slab.v, tmp.v)]
    if slab.quantized:
        pairs += [(slab.k_scale, tmp.k_scale), (slab.v_scale, tmp.v_scale)]
    for i, slot in enumerate(slots):
        for dst, src in pairs:
            dst[:, slot, :, :p_keep].copy_(src[:, i, :, :p_keep])


class Request:
    """A queued transcription request (thread-safe completion handle).

    ``temperature`` > 0 switches this request's decode from greedy argmax
    to temperature sampling, per slot: greedy and sampled requests share
    the same decode segments. ``top_p`` < 1 adds a per-slot nucleus
    filter to a sampled request (ignored at temperature 0, like the
    OpenAI API); only segments with a live nucleus request run the
    full-vocabulary sort. (top-k stays an offline-engine option.)
    """

    def __init__(self, samples: np.ndarray, language: Optional[str] = None,
                 max_new_tokens: Optional[int] = None,
                 temperature: float = 0.0, top_p: float = 1.0):
        self.samples = np.asarray(samples, np.float32).reshape(-1)
        self.language = language
        self.max_new_tokens = max_new_tokens
        if temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {temperature}"
            )
        if not 0.0 < top_p <= 1.0:
            raise ValueError(
                f"top_p must be in (0, 1], got {top_p}"
            )
        self.temperature = float(temperature)
        self.top_p = float(top_p)
        self.event = threading.Event()
        self.result: Optional[TranscribeResult] = None
        self.error: Optional[Exception] = None
        self.submit_time = time.monotonic()
        self.finish_time: Optional[float] = None

    def wait(self, timeout=None) -> TranscribeResult:
        if not self.event.wait(timeout):
            raise TimeoutError("request did not complete in time")
        if self.error is not None:
            raise self.error
        return self.result


@dataclasses.dataclass
class _Slot:
    request: Optional[Request] = None
    tokens: list = dataclasses.field(default_factory=list)
    max_new: int = 0

    @property
    def active(self) -> bool:
        return self.request is not None


@dataclasses.dataclass
class _PrefillJob:
    """In-progress chunked admission: hidden sequence + temp KV cache."""

    hidden: torch.Tensor   # (1, p_pad, H) injected embeddings
    tmp: KVCache           # (L, 1, Hkv, p_pad, D) per-admission cache
    prompt_len: int
    bucket: int
    cursor: int = 0


@dataclasses.dataclass
class _EncodeJob:
    """In-progress segmented ENCODE admission (before _PrefillJob): the
    audio encoder runs one window group per scheduler step (windows are
    independent: block-diagonal attention), so a 2-minute clip's encoder
    pass never stalls active decode slots for more than one group."""

    mel: torch.Tensor      # (n_mel, n_groups * group_frames), zero-padded
    embeds: torch.Tensor   # (n_groups * group_chunks * tpc, D) accumulator
    n_true: int
    ids: np.ndarray
    prompt_len: int
    bucket: int
    cursor: int = 0        # next window group
    n_groups: int = 0


@dataclasses.dataclass
class _Inflight:
    """A dispatched segment: its outputs' host copies (a slot of the
    pinned ring on CUDA), the event after those copies, and the slot
    versions at dispatch."""

    out: torch.Tensor
    tok: torch.Tensor
    pos: torch.Tensor
    done: torch.Tensor
    event: Optional[torch.cuda.Event]
    versions: np.ndarray


class ContinuousBatcher:
    """Slot-based continuous batching over a shared KV slab."""

    def __init__(
        self,
        engine: AsrEngine,
        n_slots: int = 8,
        segment_steps: int = 8,
        max_new_tokens: Optional[int] = None,
        max_chunks: Optional[int] = None,
        prefill_chunk_tokens: Optional[int] = 256,
        encode_window_groups: Optional[int] = 2,
        serving_precision: str = "engine",
        kv_dtype: Optional[str] = None,
        admit_batch_max: int = 8,
    ):
        require(engine.config.text, "serving", "serving (ContinuousBatcher)")
        self.engine = engine
        # the slot pool's mesh: None unless an axis has more than one rank
        self.mesh = engine.mesh if (engine._dp or engine._tp) else None
        self._dp, self._tp = engine._dp, engine._tp
        if self._dp is not None:
            n_slots = -(-n_slots // self._dp.size) * self._dp.size
        self.n_slots = n_slots
        # slots [lo, lo + n_local) are this rank's (every slot without dp)
        self.n_local = n_slots // (1 if self._dp is None else self._dp.size)
        self._lo = 0 if self._dp is None else self._dp.rank * self.n_local
        self.lead = is_lead(self.mesh)
        self.stopped = False  # a stop request reached this rank
        self._stop_asked = False
        self.segment_steps = segment_steps
        # prompts longer than this are prefilled in chunks interleaved with
        # decode segments (None: always one monolithic prefill)
        self.prefill_chunk_tokens = prefill_chunk_tokens
        # clips spanning more than this many encoder windows are encoded
        # one group of this many windows per step (None: inline encode)
        self.encode_window_groups = encode_window_groups
        if max_new_tokens is None:
            max_new_tokens = min(engine.max_new_tokens, 512)
        self.max_new = max_new_tokens
        # per-segment decode weights: "engine" (the engine's own), "bf16"
        # (the engine's unquantized tree), "int8" (an int8 copy, on any
        # mesh, or an int8 engine's tree) or "auto": int8 while at most
        # int8_max_occupancy slots are live, bf16 above
        if serving_precision not in ("engine", "auto", "bf16", "int8"):
            raise ValueError(
                f"unknown serving_precision {serving_precision!r}"
            )
        self.serving_precision = serving_precision
        self.int8_max_occupancy = int(
            os.environ.get("ASR_SERVING_INT8_MAX_OCC", "2")
        )
        self._params_by_precision = {"engine": engine.dec_params}
        if serving_precision != "engine":
            from ..weights.quantize import (
                is_quantized,
                quant_bits,
                quantize_decoder_params,
            )

            if is_quantized(engine.dec_params):
                if serving_precision in ("auto", "bf16") or quant_bits(
                    engine.dec_params
                ) != 8:
                    raise ValueError(
                        "serving_precision needs an UNQUANTIZED engine "
                        "(the batcher derives its own int8 copy); build "
                        "the engine without quantize="
                    )
                self._params_by_precision["int8"] = engine.dec_params
            else:
                self._params_by_precision["bf16"] = engine.dec_params
                if serving_precision in ("auto", "int8"):
                    # lm_bits pinned to 8: an ambient ASR_LM_BITS=4 must
                    # not leak into the serving copy. Under tp the copy is
                    # JAX's unmerged one, built from this rank's pieces:
                    # equal to the whole tree quantized, then sharded
                    self._params_by_precision["int8"] = (
                        quantize_decoder_params(
                            engine.dec_params, merge=self._tp is None,
                            lm_bits=8, tp=self._tp))
        if max_chunks is None:
            # default: cap serving admission at 2 min of audio, but never
            # below the smallest bucket (long-form-only engines)
            max_chunks = max(
                min(engine.chunk_buckets[-1], 120), engine.chunk_buckets[0]
            )
        if max_chunks < engine.chunk_buckets[0]:
            raise ValueError(
                f"max_chunks={max_chunks} is below the smallest engine "
                f"bucket {engine.chunk_buckets[0]}; no request can be "
                f"admitted"
            )
        self.max_chunks = max_chunks

        cfg = engine.config
        # int8 KV slab (opt-in, or inherited from the engine's kv_dtype):
        # half the slab bytes per decode step, twice the slots per byte
        if kv_dtype is None:
            kv_dtype = "int8" if engine.kv_quant else "bf16"
        if kv_dtype not in ("bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        if kv_dtype == "int8" and self._tp is not None:
            raise ValueError(
                "kv_dtype='int8' serving is not supported under tensor "
                "parallelism (works on dp-only meshes)")
        self.kv_quant = kv_dtype == "int8"
        # a slot writes at most up to its prompt bucket + max_new - 1 (the
        # device cap stops it there); the headroom of max(8, segment_steps)
        # slots is JAX's, which covers its pipelining overshoot
        self.s_max = (
            engine._prompt_bucket(max_chunks)
            + max_new_tokens
            + max(8, segment_steps)
        )
        self.decoder = engine.decoder
        if self.decoder.rotary.max_position < self.s_max:
            self.decoder = TextDecoder(cfg.text, max_position=self.s_max,
                                       device=engine.device, tp=self._tp)
        # the batcher owns its slab: the engine's kept first-stage slabs
        # and graphs go, the speculative loop's too
        engine._release()
        dev = engine.device
        self.device = dev
        n_local = self.n_local
        self.cache = KVCache.zeros(
            self.decoder.cfg, n_local, self.s_max, dtype=engine.dtype,
            device=dev, quantized=self.kv_quant,
        )
        self.slots = [_Slot() for _ in range(n_slots)]
        # device-resident decode state of this rank's slots at fixed
        # addresses (the captured segments read and write it): every slot
        # starts done at 0
        i64 = dict(dtype=torch.int64, device=dev)
        self.d_tok = torch.zeros(n_local, **i64)
        self.d_pos = torch.zeros(n_local, **i64)
        self.d_done = torch.ones(n_local, dtype=torch.bool, device=dev)
        self.d_temp = torch.zeros(n_local, dtype=torch.float32, device=dev)
        self.d_topp = torch.ones(n_local, dtype=torch.float32, device=dev)
        self.d_count = torch.zeros(n_local, **i64)  # tokens emitted
        self.d_cap = torch.zeros(n_local, **i64)    # tokens allowed
        self.d_out = torch.full((n_local, segment_steps), PAD_TOKEN, **i64)
        # the pool's PRNG key chain (JAX's): the base key, whose fold_ins
        # key the admissions, and the chain head the sampled segments split
        self.d_base = prng_key(
            int(os.environ.get("ASR_SAMPLING_SEED", "0"))).to(dev)
        self.d_key = self.d_base.clone()
        self._admit_seq = 0
        # host mirrors for scheduling decisions (lag by one segment)
        self.tok = np.zeros(n_slots, np.int64)
        self.pos = np.zeros(n_slots, np.int64)
        self.done = np.ones(n_slots, bool)
        # admissions/finishes bump a slot's version; a drained segment only
        # applies to slots whose version matches its dispatch
        self._slot_version = np.zeros(n_slots, np.int64)
        self._inflight: Optional[_Inflight] = None
        self.cuda = dev.type == "cuda"
        # on CUDA: (variant, precision) -> the segment's captured graph
        self._graphs: dict = {}
        self._side = self._pool = None
        if self.cuda:  # two pinned host slots for every slot's outputs
            self._ring = [
                [torch.empty((n_slots,) + t.shape[1:], dtype=t.dtype,
                             pin_memory=True)
                 for t in (self.d_out, self.d_tok, self.d_pos, self.d_done)]
                for _ in range(2)
            ]
            self._ring_i = 0
        # what ran: decode segments and steps (those of sampled or nucleus
        # segments, one draw each, apart), graph replays and captures; and
        # this rank's admission work: encoder calls and one-pass prefills
        self.stats = {"segments": 0, "steps": 0, "sampled_steps": 0,
                      "replays": 0, "captures": 0, "encodes": 0,
                      "prefills": 0}
        # the segment variants run, and the (bucket, padded size) pairs of
        # batched admission (warmup covers every one live traffic needs)
        self.variants_run: set = set()
        self.batch_shapes: set = set()

        # batched admission: same-bucket monolithic admissions queued at
        # one scheduler step coalesce into one prefill of up to this many
        # requests (power-of-two padded; <= 1 disables)
        self.admit_batch_max = max(1, int(admit_batch_max))

        self.queue: "queue.Queue[Request]" = queue.Queue()
        self.prefilling: dict[int, _PrefillJob] = {}
        self.encoding: dict[int, _EncodeJob] = {}

    def _group_chunks(self, bucket: int) -> int:
        """Chunks per encode group (whole windows only)."""
        cpw = min(self.engine.config.audio.chunks_per_window, bucket)
        return cpw * (self.encode_window_groups or 1)

    def _p_pad(self, bucket: int) -> int:
        """The bucket's prompt length padded to whole prefill chunks."""
        c = self.prefill_chunk_tokens
        return -(-self.engine._prompt_bucket(bucket) // c) * c

    # -------------------------------------------------------------- #
    # admission work on the device (eager: once per request)

    def _to_device(self, array) -> torch.Tensor:
        """A host array on the device; on CUDA through pinned memory and
        without waiting for the stream (a segment may be in flight)."""
        t = torch.as_tensor(np.asarray(array))
        if self.cuda:
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _encode(self, wave: np.ndarray, n_true: int):
        """mel -> encoder for one padded waveform: (embeds, n_audio)."""
        eng = self.engine
        mel = log_mel_from_padded(self._to_device(wave), n_true,
                                  eng.mel_filters)
        self.stats["encodes"] += 1
        return eng.encoder(eng.enc_params, mel, n_true)

    def _inject(self, ids: np.ndarray, embeds, n_audio, p_len=None):
        """Token embeddings of the (n, P) prompt ids with row i's first
        n_audio[i] audio embeddings at AUDIO_OFFSET (the offline
        engine's injection), zero-padded to ``p_len`` slots."""
        ids_t = self._to_device(np.asarray(ids, np.int64))
        hidden = self.decoder.embed(self.engine.dec_params, ids_t)
        for i, (e, n) in enumerate(zip(embeds, n_audio)):
            hidden[i, AUDIO_OFFSET: AUDIO_OFFSET + n] = e[:n].to(hidden.dtype)
        if p_len is not None and p_len > hidden.shape[1]:
            hidden = torch.nn.functional.pad(
                hidden, (0, 0, 0, p_len - hidden.shape[1]))
        return hidden

    def _first_tokens(self, logits, key: KeyChain, temps, topps, rows):
        """Each admitted row's first token: the argmax, or JAX's draw with
        the admission's ``key`` under the per-row top_p filter (applied
        whenever a row samples, as JAX's admission graphs do), row j
        drawing as row ``rows[j]`` of the admitted batch."""
        if not any(t > 0 for t in temps):
            return torch.argmax(logits, dim=-1)
        return sample_token(
            logits, key, self._to_device(np.asarray(temps, np.float32)),
            top_p=self._to_device(np.asarray(topps, np.float32)),
            row_offset=self._to_device(np.asarray(rows, np.int64)))

    def _local(self, slot_idx: int) -> Optional[int]:
        """Slot ``slot_idx``'s row in this rank's slab and device state, or
        None when another dp rank holds it."""
        i = slot_idx - self._lo
        return i if 0 <= i < self.n_local else None

    def _new_tmp(self, batch: int, length: int) -> KVCache:
        return KVCache.zeros(self.decoder.cfg, batch, length,
                             dtype=self.engine.dtype, device=self.device,
                             quantized=self.kv_quant)

    # -------------------------------------------------------------- #
    # host scheduling

    def submit(self, req: Request) -> None:
        n_frames = num_mel_frames(len(req.samples))
        cf = self.engine.config.audio.chunk_frames
        if -(-n_frames // cf) > self.max_chunks:
            raise ValueError(
                f"audio needs {-(-n_frames // cf)} chunks, exceeding the "
                f"server's {self.max_chunks}-chunk slots; use the offline "
                f"engine's long-form path"
            )
        self.queue.put(req)

    def _prepare(self, req: Request):
        """Host-side admission prep: bucket, padded wave, prompt ids."""
        engine = self.engine
        cf = engine.config.audio.chunk_frames
        n_frames = num_mel_frames(len(req.samples))
        bucket = engine._pick_bucket(n_frames)
        wave, n_true = pad_waveform(
            req.samples, bucket_frames=bucket * cf
        )
        n_audio = audio_tokens(engine.config.audio, n_true)
        prompt = build_prompt(n_audio, req.language, engine.tokenizer)
        p_bucket = engine._prompt_bucket(bucket)
        if len(prompt) > p_bucket:
            raise ValueError("prompt exceeds bucket; language string too long")
        ids = np.zeros(p_bucket, np.int64)
        ids[: len(prompt)] = prompt
        return bucket, wave, n_true, ids, len(prompt)

    def _next_admit_key(self) -> KeyChain:
        """The key of the next admission prefill: JAX's ``fold_in(base,
        n)`` for the n-th (every rank counts every admission)."""
        self._admit_seq += 1
        return KeyChain(self.d_base, (self._admit_seq,))

    def _occupy(self, slot_idx: int, req: Request) -> _Slot:
        """Hand slot ``slot_idx`` to ``req``."""
        slot = self.slots[slot_idx]
        slot.request = req
        slot.tokens = []
        slot.max_new = min(req.max_new_tokens or self.max_new, self.max_new)
        return slot

    def _admit_monolithic(self, slot_idx, req, bucket, wave, n_true, ids,
                          prompt_len) -> None:
        """One request's encoder and prefill, written into its slot."""
        self._admit_rows([(slot_idx, req,
                           (bucket, wave, n_true, ids, prompt_len))])

    def _admit_batch(self, items) -> None:
        """Admit same-bucket monolithic requests in ONE batched prefill.

        ``items``: list of (slot_idx, req, prep) with identical buckets.
        The batch pads to the next power of two by repeating row 0 (slot
        included): the duplicate rows write the same data into the same
        slot, and their first tokens are ignored. Row b's slab content and
        first token are those of its monolithic admission. On a dp mesh
        each rank prefills (and pads) the rows of its own slots.
        """
        n = 1 << (len(items) - 1).bit_length()
        self.batch_shapes.add((items[0][2][0], n))
        self._admit_rows(items, pad=True)

    @torch.inference_mode()
    def _admit_rows(self, items, pad: bool = False) -> None:
        """Every request (slot_idx, req, prep) of ``items`` (one bucket,
        distinct slots) takes its slot; the rows of this rank's slots
        (``pad``: padded to a power of two by repeating the first) run
        the encoder, injection and one left-aligned prefill, each row's
        cache copied into its slot; then every slot's decode state is
        set. The admission takes one key; row j draws as row j of the
        padded batch."""
        for slot_idx, req, _ in items:
            self._occupy(slot_idx, req)
        key = self._next_admit_key()
        rows = [it for it in items if self._local(it[0]) is not None]
        tok0 = {}
        if rows:
            if pad:
                rows += [rows[0]] * ((1 << (len(rows) - 1).bit_length())
                                     - len(rows))
            encoded = {}  # a padding row repeats row 0: encode it once
            for slot_idx, _, prep in rows:
                if slot_idx not in encoded:
                    encoded[slot_idx] = self._encode(prep[1], prep[2])
            embeds, n_audio = zip(*(encoded[s] for s, _, _ in rows))
            hidden = self._inject(np.stack([prep[3] for _, _, prep in rows]),
                                  embeds, n_audio)
            p = hidden.shape[1]
            tmp = self._new_tmp(len(rows), p)
            self.stats["prefills"] += 1
            logits, _ = self.decoder.prefill(
                self.engine.dec_params, hidden,
                torch.arange(p, device=self.device), tmp,
                [prep[4] for _, _, prep in rows])
            _write_slot_rows(self.cache, tmp,
                             [self._local(s) for s, _, _ in rows])
            first = self._first_tokens(
                logits, key, [r.temperature for _, r, _ in rows],
                [r.top_p for _, r, _ in rows],
                [items.index(it) for it in rows])
            for j, (slot_idx, _, _) in enumerate(rows):
                tok0.setdefault(slot_idx, first[j])
        for slot_idx, req, prep in items:
            slot = self.slots[slot_idx]
            self._set_slot_state(
                slot_idx, tok0.get(slot_idx, 0), prep[4], False,
                temperature=req.temperature, top_p=req.top_p,
                cap=slot.max_new,
            )
        logger.debug("admitted %d request(s) into slots %s (bucket %d)",
                     len(items), [i for i, _, _ in items], items[0][2][0])

    @torch.inference_mode()
    def _start_chunked(self, slot_idx, req, bucket, wave, n_true, ids,
                       prompt_len) -> None:
        """Begin chunked admission.

        The slot is reserved (not re-admittable) but stays out of decode
        (done flag) until _advance_prefill commits the finished cache.
        Clips spanning several encoder window groups also SEGMENT the
        encoder pass (one group per scheduler step); shorter clips
        encode inline and go straight to chunked prefill.
        """
        eng = self.engine
        self._occupy(slot_idx, req)
        self._set_slot_state(slot_idx, 0, 0, True)  # out of decode
        mine = self._local(slot_idx) is not None  # else: host state only
        acfg = eng.config.audio
        gchunks = self._group_chunks(bucket)
        if (
            self.encode_window_groups is not None
            and bucket > gchunks
            and min(acfg.chunks_per_window, bucket) == acfg.chunks_per_window
        ):
            n_groups = -(-bucket // gchunks)
            mel = buf = None
            if mine:
                mel = log_mel_from_padded(
                    torch.from_numpy(wave).to(self.device), n_true,
                    eng.mel_filters)
                mel = torch.nn.functional.pad(
                    mel,
                    (0, (n_groups * gchunks - bucket) * acfg.chunk_frames))
                buf = torch.zeros(
                    (n_groups * gchunks * acfg.tokens_per_chunk,
                     acfg.output_dim), dtype=eng.dtype, device=self.device)
            self.encoding[slot_idx] = _EncodeJob(
                mel=mel, embeds=buf, n_true=n_true, ids=ids,
                prompt_len=prompt_len, bucket=bucket, n_groups=n_groups,
            )
            logger.debug("slot %d segmented-encode admission started "
                         "(%d groups of %d chunks)", slot_idx, n_groups,
                         gchunks)
            return
        hidden = None
        if mine:
            embeds, n_audio = self._encode(wave, n_true)
            hidden = self._inject(ids[None], [embeds], [n_audio],
                                  self._p_pad(bucket))
        self._begin_prefill(slot_idx, bucket, hidden, prompt_len)
        logger.debug("slot %d chunked admission started (prompt %d, "
                     "chunk %d)", slot_idx, prompt_len,
                     self.prefill_chunk_tokens)

    def _begin_prefill(self, slot_idx, bucket, hidden, prompt_len) -> None:
        """A chunked prefill job; ``hidden`` None: another dp rank's slot
        (its job advances on the host only)."""
        self.prefilling[slot_idx] = _PrefillJob(
            hidden=hidden, prompt_len=prompt_len, bucket=bucket,
            tmp=None if hidden is None else self._new_tmp(1, hidden.shape[1]),
        )

    @torch.inference_mode()
    def _advance_encode(self, slot_idx: int) -> None:
        """Run ONE encoder window group; hand off to prefill when done.
        A group's encode equals the full-clip encode on its windows:
        windows attend block-diagonally, the conv stem and positional
        embedding are chunk-local, valid tokens are counted per chunk."""
        job = self.encoding[slot_idx]
        eng = self.engine
        acfg = eng.config.audio
        gchunks = self._group_chunks(job.bucket)
        gframes = gchunks * acfg.chunk_frames
        g = job.cursor
        n_true_g = min(max(job.n_true - g * gframes, 0), gframes)
        if job.mel is not None:  # this rank's slot
            self.stats["encodes"] += 1
            embeds, _ = eng.encoder(
                eng.enc_params, job.mel[:, g * gframes:(g + 1) * gframes],
                n_true_g)
            at = g * gchunks * acfg.tokens_per_chunk
            job.embeds[at: at + embeds.shape[0]] = embeds.to(
                job.embeds.dtype)
        job.cursor += 1
        if job.cursor >= job.n_groups:
            hidden = None if job.mel is None else self._inject(
                job.ids[None], [job.embeds],
                [eng.encoder.valid_tokens(job.n_true)],
                self._p_pad(job.bucket))
            del self.encoding[slot_idx]
            self._begin_prefill(slot_idx, job.bucket, hidden,
                                job.prompt_len)
            logger.debug("slot %d encode complete; chunked prefill begins",
                         slot_idx)

    @torch.inference_mode()
    def _advance_prefill(self, slot_idx: int) -> None:
        """Run ONE bounded prefill chunk; commit to the slab when done.
        Every chunk takes an admission key, as JAX's chunk graph does; the
        last one's draws the first token."""
        job = self.prefilling[slot_idx]
        slot = self.slots[slot_idx]
        req = slot.request
        key = self._next_admit_key()
        c = self.prefill_chunk_tokens
        true_in = min(c, job.prompt_len - job.cursor)
        if job.hidden is not None:  # this rank's slot
            logits, _ = self.decoder.prefill_chunk(
                self.engine.dec_params,
                job.hidden[:, job.cursor: job.cursor + c], job.cursor,
                job.tmp, true_in,
            )
        job.cursor += c
        if job.cursor >= job.prompt_len:
            tok0 = 0
            if job.hidden is not None:
                tok0 = self._first_tokens(logits, key, [req.temperature],
                                          [req.top_p], [0])[0]
                _write_slot_rows(self.cache, job.tmp,
                                 [self._local(slot_idx)])
            self._set_slot_state(
                slot_idx, tok0, job.prompt_len, False,
                temperature=req.temperature, top_p=req.top_p,
                cap=slot.max_new,
            )
            del self.prefilling[slot_idx]
            logger.debug("slot %d prefill committed (%d prompt tokens)",
                         slot_idx, job.prompt_len)

    def _set_slot_state(self, i, tok0, pos0, done, temperature: float = 0.0,
                        top_p: float = 1.0, cap: int = 0) -> None:
        """Write one slot's decode state into the device tensors (where
        this rank holds the slot), in place and on the stream, before the
        next segment is enqueued, and into the host mirror.

        ``tok0`` may be a device scalar (no host sync — the host tok
        mirror is not used for scheduling). Bumps the slot version so an
        already-inflight segment cannot clobber this slot at drain.
        """
        j = self._local(i)
        if j is not None:
            self.d_tok[j] = tok0
            self.d_pos[j] = pos0
            self.d_done[j] = bool(done)
            self.d_temp[j] = temperature
            self.d_topp[j] = top_p
            self.d_count[j] = 0
            self.d_cap[j] = cap
        self.tok[i] = 0
        self.pos[i] = pos0
        self.done[i] = bool(done)
        self._slot_version[i] += 1

    def _finish(self, slot_idx: int) -> None:
        slot = self.slots[slot_idx]
        req = slot.request
        try:
            raw = self.engine.tokenizer.decode(slot.tokens)
            lang, text = parse_asr_output(raw, req.language is not None)
            req.result = TranscribeResult(
                text=text, language=lang, raw_output=raw
            )
        except Exception as e:  # noqa: BLE001 — the client gets the error
            req.error = e
        req.finish_time = time.monotonic()
        req.event.set()
        slot.request = None
        # the device done flag too: the slot keeps its position, writes
        # there until readmission and emits nothing
        self._set_slot_state(slot_idx, 0, int(self.pos[slot_idx]), True)
        logger.debug(
            "slot %d finished with %d tokens", slot_idx, len(slot.tokens)
        )

    def _segment_params(self):
        """(precision name, decoder params) of the next segment.

        "auto" picks int8 when at most ``int8_max_occupancy`` slots are
        live (the weight stream bounds the step) and bf16 above it. The
        host ``done`` mirror lags one segment — a heuristic input, never a
        correctness one.
        """
        mode = self.serving_precision
        if mode == "auto":
            live = sum(
                1 for i, s in enumerate(self.slots)
                if s.active and not self.done[i]
            )
            mode = "int8" if live <= self.int8_max_occupancy else "bf16"
        return mode, self._params_by_precision[mode]

    def _segment_fn(self, variant: str, params):
        """``segment_steps`` decode steps over every slot on the device
        state (JAX's segment body): a slot that is done emits PAD and
        keeps its token and position; a slot whose token is an EOS turns
        done without emitting it; one that has emitted ``cap`` tokens
        turns done after the last. Every slot steps, done or not, at its
        own position (K2 at each row's own end).

        ``variant``: "greedy" (argmax), "sample" (per-row temperature; 0
        takes the argmax) or "nucleus" (also the per-row top_p filter).
        A sampled step splits the pool's key chain and draws with the
        subkey over every slot, this rank's at their rows of the pool."""
        dec = self.decoder
        eos0, eos1 = ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID
        tok, pos, done, count = (self.d_tok, self.d_pos, self.d_done,
                                 self.d_count)

        def segment():
            for i in range(self.segment_steps):
                done.logical_or_((tok == eos0) | (tok == eos1))
                self.d_out[:, i] = torch.where(done, PAD_TOKEN, tok)
                count.add_((~done).to(torch.int64))
                stop = done | (count >= self.d_cap)
                logits, _ = dec.decode_step(params, tok, pos, self.cache)
                if variant == "greedy":
                    ntok = torch.argmax(logits, dim=-1)
                else:
                    ntok = sample_token(
                        logits, KeyChain(self.d_key, then_split=True),
                        self.d_temp,
                        top_p=self.d_topp if variant == "nucleus" else 1.0,
                        row_offset=self._lo)
                tok.copy_(torch.where(stop, tok, ntok))
                pos.add_((~stop).to(torch.int64))
                done.copy_(stop)

        return segment

    def _capture(self, fn) -> StepGraph:
        """Run ``fn`` (a real segment) eagerly on the capture stream, then
        capture it into the batcher's graph memory pool."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return capture(fn, self._side, self._pool)

    @torch.inference_mode()
    def _dispatch_segment(self) -> None:
        """Enqueue one decode segment on the device state, then the copy
        of its outputs to the host (no wait)."""
        # the sampling/nucleus variants only when some live slot asked
        # for them — the host temperature/top_p are exact (set at
        # admission under the scheduler thread, never device-written)
        live = [s.request for s in self.slots if s.active]
        if any(r.temperature > 0 and r.top_p < 1.0 for r in live):
            variant = "nucleus"
        elif any(r.temperature > 0 for r in live):
            variant = "sample"
        else:
            variant = "greedy"
        prec, params = self._segment_params()
        self.variants_run.add((variant, prec))
        fn = self._segment_fn(variant, params)
        if self.cuda and self._tp is None:
            graph = self._graphs.get((variant, prec))
            if graph is None:
                self._graphs[(variant, prec)] = self._capture(fn)
                self.stats["captures"] += 1
            else:
                graph.replay()
                self.stats["replays"] += 1
        else:
            fn()
        self.stats["segments"] += 1
        self.stats["steps"] += self.segment_steps
        if variant != "greedy":
            self.stats["sampled_steps"] += self.segment_steps
        state = (self.d_out, self.d_tok, self.d_pos, self.d_done)
        if self._dp is not None:  # every slot's outputs, on every rank
            state = self._gather_state(state)
        event = None
        if self.cuda:
            host = self._ring[self._ring_i]
            self._ring_i ^= 1
            for h, d in zip(host, state):
                h.copy_(d, non_blocking=True)
            event = torch.cuda.Event()
            event.record()
        else:
            host = [t.clone() for t in state]
        self._inflight = _Inflight(*host, event=event,
                                   versions=self._slot_version.copy())

    def _gather_state(self, state):
        """The (out, tok, pos, done) of every slot: this rank's packed in
        one int64 tensor and all-gathered over dp, in slot order."""
        out, tok, pos, done = state
        packed = torch.cat([out, tok[:, None], pos[:, None],
                            done[:, None].long()], 1)
        full = torch.cat(all_gather(packed, self._dp), 0)
        n = self.segment_steps
        return full[:, :n], full[:, n], full[:, n + 1], full[:, n + 2].bool()

    def _drain(self) -> None:
        """Read + apply the previously dispatched segment's results.

        Called AFTER the next segment is dispatched, so this host wait
        overlaps device compute. A slot whose version changed since
        dispatch (re-admitted or force-finished) is skipped.
        """
        if self._inflight is None:
            return
        fl = self._inflight
        self._inflight = None
        if fl.event is not None:
            fl.event.synchronize()
        out, tok, pos, done = (t.numpy() for t in
                               (fl.out, fl.tok, fl.pos, fl.done))
        for i, slot in enumerate(self.slots):
            if self._slot_version[i] != fl.versions[i]:
                continue
            self.tok[i] = tok[i]
            self.pos[i] = pos[i]
            self.done[i] = done[i]
            if (not slot.active or i in self.prefilling
                    or i in self.encoding):
                continue
            emitted = out[i][out[i] != PAD_TOKEN].tolist()
            room = slot.max_new - len(slot.tokens)
            slot.tokens.extend(emitted[:room])
            if done[i] or len(slot.tokens) >= slot.max_new:
                self._finish(i)

    def _take(self, block_timeout: Optional[float]) -> list:
        """The queued requests to admit now: one per free slot, in queue
        order; with ``block_timeout`` (an idle pool) and an empty queue,
        the one request that arrives within that time (JAX's scheduler
        admits it alone). On a mesh the lead rank takes them and
        broadcasts them (with a stop request, ``request_stop``) to every
        rank, whose copies stand in for them."""
        stop, self._stop_asked = self._stop_asked, False
        reqs = []
        if self.lead and not stop:
            free = sum(not s.active for s in self.slots)
            try:
                while len(reqs) < free:
                    reqs.append(self.queue.get_nowait())
            except queue.Empty:
                if block_timeout is not None and not reqs:
                    try:
                        reqs.append(self.queue.get(timeout=block_timeout))
                    except queue.Empty:
                        pass
        if self.mesh is None:
            self.stopped = stop
            return reqs
        msg = [(stop, [
            (r.samples, r.language, r.max_new_tokens, r.temperature,
             r.top_p) for r in reqs])]
        (stop, shared), = broadcast_from_lead(msg, self.mesh)
        self.stopped = stop
        return reqs if self.lead else [Request(*args) for args in shared]

    def request_stop(self) -> None:
        """Make the next step take nothing and set ``stopped``, on every
        rank of a mesh (asked on the lead rank: the others learn it from
        its broadcast)."""
        self._stop_asked = True

    def _from_lead(self, value):
        """The lead rank's ``value`` on every rank of the mesh."""
        if self.mesh is None:
            return value
        return broadcast_from_lead([value], self.mesh)[0]

    def drive(self, requests, block_timeout: float = 0.001) -> None:
        """Submit ``requests`` (on the lead rank; the others' are ignored)
        and step until the lead rank's have finished. SPMD: every rank of
        a mesh calls it, with requests of the same count and order."""
        if self.lead:
            for r in requests:
                self.submit(r)
        while not self._from_lead(all(r.event.is_set() for r in requests)):
            self.step(block_timeout=block_timeout)

    def _admit(self, reqs: list) -> bool:
        """Admit ``reqs`` into the free slots, in slot order: prompts over
        the chunk size start chunked admission, the rest coalesce by
        bucket into batched prefills of at most ``admit_batch_max``.
        Returns whether any request was admitted."""
        admitted = False
        batchable: dict[int, list] = {}
        c = self.prefill_chunk_tokens
        free = (i for i, slot in enumerate(self.slots) if not slot.active)
        for i, req in zip(free, reqs):
            try:
                prep = self._prepare(req)
                bucket, prompt_len = prep[0], prep[4]
                if c is not None and prompt_len > c:
                    self._start_chunked(i, req, *prep)
                    admitted = True
                elif self.admit_batch_max > 1:
                    batchable.setdefault(bucket, []).append((i, req, prep))
                else:
                    self._admit_monolithic(i, req, *prep)
                    admitted = True
            except Exception as e:  # noqa: BLE001 — fail this request only
                self._fail_admission([(i, req)], e)
        for items in batchable.values():
            while items:
                group = items[: self.admit_batch_max]
                items = items[self.admit_batch_max:]
                try:
                    if len(group) == 1:
                        i, req, prep = group[0]
                        self._admit_monolithic(i, req, *prep)
                    else:
                        self._admit_batch(group)
                    admitted = True
                except Exception as e:  # noqa: BLE001 — fail the group
                    self._fail_admission([(i, r) for i, r, _ in group], e)
        return admitted

    @torch.inference_mode()
    def step(self, block_timeout: float = 0.05) -> bool:
        """One scheduler iteration. Returns True if any work was done.

        Order matters: admissions first (their device work precedes the
        segment), then the next decode segment is ENQUEUED, and only then
        is the previous segment DRAINED — decode never waits on the host
        round trip (segment pipelining).
        """
        # idle: block briefly for the next request
        idle = not any(s.active for s in self.slots) and self._inflight is None
        reqs = self._take(block_timeout if idle else None)
        if self.stopped:
            return False
        self._admit(reqs)
        if idle:
            if not reqs:
                return False
            if not any(s.active for s in self.slots):
                return True  # the admission failed

        # advance each mid-admission slot by ONE bounded unit of work (an
        # encoder window group, or a prefill chunk) so a long clip never
        # stalls decoding slots for more than one dispatch
        for jobs, advance in ((self.encoding, self._advance_encode),
                              (self.prefilling, self._advance_prefill)):
            for i in list(jobs):
                try:
                    advance(i)
                except Exception as e:  # noqa: BLE001
                    jobs.pop(i, None)
                    self._fail_admission([(i, self.slots[i].request)], e)

        decodable = any(
            s.active and i not in self.prefilling and i not in self.encoding
            for i, s in enumerate(self.slots)
        )
        if decodable:
            self._dispatch_segment()
        self._drain()
        return True

    def _fail_admission(self, items, error: Exception) -> None:
        """Fail the requests of a failed admission and free their slots."""
        for i, req in items:
            req.error = error
            req.event.set()
            if self.slots[i].request is req:
                self.slots[i].request = None
                self._set_slot_state(i, 0, 0, True)

    def warmup(self, buckets=None) -> None:
        """Run every path live traffic needs before the first request.

        Drives synthetic silent requests through the scheduler: one per
        audio bucket (each bucket's admission), a burst of each batched
        size up to ``min(admit_batch_max, n_slots)`` per bucket, then
        full-occupancy bursts and solo requests with a sampled and with a
        nucleus member, so that every segment variant runs (and, on CUDA,
        is captured) at both occupancies — in ``serving_precision="auto"``
        both precisions. A capture inside live traffic would stall every
        active request.
        """
        cf = self.engine.config.audio.chunk_frames
        if buckets is None:
            buckets = [
                c for c in self.engine.chunk_buckets
                if c <= self.max_chunks
            ]
        # one decode segment per synthetic request runs every path
        max_new = max(1, self.segment_steps)

        run = self.drive

        for c in buckets:
            clip = np.zeros(int(c * cf * 160), np.float32)
            run([Request(samples=clip, max_new_tokens=max_new)])
            logger.info("serving warmup: bucket %d chunks", c)
        for c in buckets:
            clip = np.zeros(int(c * cf * 160), np.float32)
            g = 2
            while g <= min(self.admit_batch_max, self.n_slots):
                run([Request(samples=clip, max_new_tokens=max_new)
                     for _ in range(g)])
                g *= 2
        small = np.zeros(int(min(buckets) * cf * 160), np.float32)
        for temperature, top_p in ((0.7, 1.0), (0.7, 0.9)):
            run([Request(samples=small, max_new_tokens=max_new,
                         temperature=temperature if i == 0 else 0.0,
                         top_p=top_p if i == 0 else 1.0)
                 for i in range(self.n_slots)])
            run([Request(samples=small, max_new_tokens=max_new,
                         temperature=temperature, top_p=top_p)])
        logger.info("serving warmup: %d-slot burst (every precision, "
                    "greedy + sampling + nucleus segments)", self.n_slots)


class ServingLoop(threading.Thread):
    """Background thread driving a ContinuousBatcher."""

    def __init__(self, batcher: ContinuousBatcher):
        super().__init__(daemon=True)
        self.batcher = batcher
        # NOT named _stop: Thread's internals call a private _stop()
        # method during join(), which an Event attribute would shadow.
        self._stop_event = threading.Event()

    def stop(self):
        self._stop_event.set()

    def run(self):
        self.batcher.stopped = False
        while not self.batcher.stopped:
            if self._stop_event.is_set():
                self.batcher.request_stop()
            try:
                self.batcher.step()
            except Exception:  # noqa: BLE001 — the loop must keep serving
                logger.exception("serving loop iteration failed")
                self._fail_in_flight()

    def _fail_in_flight(self) -> None:
        """Mark every slot done, on the device too, and fail every
        in-flight request rather than hang its client."""
        b = self.batcher
        failed = [s.request for s in b.slots if s.active]
        for slot in b.slots:
            slot.request = None
        b.done[:] = True
        b.prefilling.clear()
        b.encoding.clear()
        b._inflight = None
        try:
            b.d_done.fill_(True)
        finally:
            for req in failed:
                req.error = RuntimeError("serving loop failure")
                req.event.set()
