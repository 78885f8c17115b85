"""AsrEngine — end-to-end transcription in PyTorch.

Port of ``qwen3_asr_rs_tpu/runtime/engine.py``: log-mel -> audio
encoder -> prompt embedding with the audio
embeddings injected at ``AUDIO_OFFSET`` -> prefill -> decode until an EOS
token or ``max_new_tokens``, greedy or sampled (``sampling=``: the
temperature, top-k, top-p and seed of ``runtime/sampling.py``), for one
utterance (left-aligned prompt) or a batch (``transcribe_batch``: padded
to a power of two with born-done rows, one shared chunk bucket,
right-aligned prompts, per-row EOS). Audio lengths round up to the same
chunk buckets and prompt buckets as the JAX engine; ``transcribe`` cuts
longer audio into overlapped segments (``runtime/longform.py``) and
attaches time-stamped segments with word times to every result.

The decode loop runs on device state, as the JAX engine's
``lax.while_loop`` does (``_generate``): the pending token, the tokens
per row, done flags, the token buffer and the step counter stay on the
device, and the slab grows in segments (``ASR_DECODE_SEGMENT`` tokens,
then 4x per stage). On CUDA each step is a CUDA graph replay
(``runtime/cuda_graph.py``), with one non-blocking read of the done
flags per chunk of steps and one read of the tokens per transcription.
Device memory: the first stage's slab and graphs stay with the engine
per batch size, so that a short transcription captures nothing; a call
that decodes past the first stage frees them and allocates and captures
its later stages itself, which it frees at its end.

Differences from the JAX engine, none of which changes the greedy
tokens: slabs round up to 8 slots, not the JAX engine's 8/128 (masks
make the output independent of the slab length); the loop stops one
decode step earlier at the cap (the JAX loop's last step makes a token
it discards). Sampled draws are JAX's: ``prng_key(seed)``, the prefill's
token at ``fold_in(key, 0)``, step i's at ``fold_in(key, step + 1)``
(``ops/prng.py``), so a seed gives the JAX engine's tokens. Weight
quantization follows the JAX engine's
``quantize=`` modes 'int8', 'int4', 'int4g' (group-wise int4,
``ASR_INT4_GROUP``) and 'lm8' (with ``ASR_MERGE_QKV`` and
``ASR_LM_BITS``), the KV slab its ``kv_dtype=`` 'bf16' (the compute
dtype) and 'int8' (``ASR_KV``), and ``ASR_FOLD_LM=1`` folds the lm_head
and argmax into the decode kernel for greedy steps (default off, as in
JAX). Stage timers (``utils/tracing.py``): ``device_dispatch`` per
transcription, ``warmup_c{c}_b{b}`` per warmed graph set. Spans, recorded
while the tracer is on (``ASR_TRACE=1``, or while a torch profiler
records): ``prefill.encode`` (``_embed_prompts``, whole: mel, encoder,
token embedding and audio injection), inside it once per call
``prefill.mel`` (the host loop's padding and prompt ids, the copies to
the device, the batched log-mel) and ``prefill.encoder`` (the batched
encoder, and the draft's), ``prefill.decoder`` (the text decoder's
prefill), ``wait.prefill`` (the state's reset, where ``_generate``'s
blocking copy of the live rows from the host waits for the prefill on
the card, and on CUDA the synchronize after the first token),
``wait.done_flags`` (each wait for the done flags) and
``wait.read_out`` (the loop's final reads of its state).

The decoder is the text config's architecture's (``models/decoders.py``;
``_slab0`` and the staged slabs take its ``cache_type``). Its per-call
counters (``call_counts``, in ``_DecodeState.counts``) go to the prefill
and every decode step as ``counts=`` and are read once in
``wait.read_out`` (``read_counts``). Speculative decoding, quantized
weights, an int8 cache and tensor parallelism call ``require`` first.

Speculative decoding (``speculative=``, ``spec_k=``, ``draft_model=``,
as in JAX) runs every B = 1 transcription as draft-and-verify
(``_spec_generate``): a draft (a quantized copy of this checkpoint, or a
smaller checkpoint with its own encoder, embeddings and slab) decodes
k + 1 tokens with ordinary decode steps over its own slab, the target
scores the block once (``TextDecoder.score_chunk``), and the accepted
prefix is emitted: greedy output equals plain greedy decoding's, and
speculative sampling draws from the target's distribution
(``sampling.speculative_accept``). The state stays on the device, as in
the plain loop; on CUDA one iteration (the draft steps, the verify, the
acceptance and the window write) is one CUDA graph replay, masked once
the stream is done or past its stage's cap. Batches keep the plain loop.
Differences from JAX's loops, none of which changes a token: the slabs
carry k + 1 more slots of slack (a masked iteration's writes land past
the live slots), and on an int8 slab the verify attends its own K/V
unquantized, as a decode step does (``TextDecoder.score_chunk``).

Device meshes (``mesh=``, a ('dp', 'tp') ``DeviceMesh`` of
``parallel/mesh.py``) are SPMD: every rank builds the engine from the
same full weights and makes the same call. Under dp each rank takes rows
[r b / dp, (r + 1) b / dp) of the batch (padded to a multiple of dp, a
lone utterance too) through the whole single-device path, kernels, CUDA
graphs and every quantization included, with no collective, and the
results are gathered so that every rank returns the whole list in
order; a sampled rank draws with ``fold_in(key, dp rank)`` over its own
rows, as JAX's shard_map does. Under tp the
weights are Megatron shards (``parallel/sharding.py``) and the decoder
(and the encoder, where its heads divide) insert their collectives; the
decode kernel is declined, as in JAX, and the loop runs eagerly (gloo
collectives cannot be captured in a CUDA graph). The JAX engine's tp
refusals hold: int8 KV, int4g and lm8 raise; int4 packs block-locally
per shard (``tp_blocks``) with an int8 lm_head and unmerged projections.
Speculative decoding raises under any mesh, as in JAX. A mesh whose axes
are all 1 runs exactly the no-mesh engine.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..audio.load import load_audio
from ..config import AsrConfig, audio_tokens
from ..features.mel import (
    create_mel_filterbank,
    log_mel_from_padded,
    num_mel_frames,
    pad_waveform,
)
from ..models.audio_encoder import AudioEncoder
from ..models.decoders import decoder_class, require
from ..models.text_decoder import KVCache
from ..ops.kernels.decode_layer import int4g_group_supported
from ..ops.prng import KeyChain, fold_in, prng_key
from ..parallel.comm import mesh_axis
from ..parallel.mesh import mesh_dims
from ..parallel.sharding import (
    decoder_param_specs,
    encoder_param_specs,
    int4_decoder_param_specs,
    quantized_decoder_param_specs,
    shard_params,
)
from ..tokenizer import ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID, AsrTokenizer
from ..weights.convert import to_torch
from ..weights.loader import load_model_params
from ..weights.quantize import quantize_decoder_params, quantize_lm_head_only
from ..utils.tracing import span, stage_timer
from .cuda_graph import StepGraph, capture
from .longform import Segment, attach_words, transcribe_long
from .prompt import AUDIO_OFFSET, build_prompt, parse_asr_output
from .sampling import (
    SamplingParams,
    filtered_probs,
    normalize,
    sample_token,
    speculative_accept,
)

logger = logging.getLogger(__name__)

# Audio-length buckets in encoder chunks (1 chunk == 1 s of audio).
DEFAULT_CHUNK_BUCKETS = (1, 2, 4, 8, 15, 30, 60, 120, 240, 360)

# Prompt-length allowance beyond the audio tokens: header(9) + tail(6)
# + forced-language tokens (a handful). Rounded up for alignment.
PROMPT_SLACK = 32

EOS_TOKEN_IDS = (ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID)


def _group(arena_key):
    """The group of a kept arena's key: B, or "spec" for ("spec", ...)."""
    return arena_key[0] if isinstance(arena_key, tuple) else arena_key


@dataclasses.dataclass
class DraftBundle:
    """A second, smaller model drafting for speculative decoding (JAX
    ``DraftBundle``): it shares the target's mel features and prompt ids
    but runs its own audio encoder, embedding table and KV slab (its
    widths differ from the target's)."""

    config: AsrConfig
    encoder: AudioEncoder
    decoder: object
    enc_params: object
    dec_params: object


@dataclasses.dataclass
class TranscribeResult:
    text: str
    language: str
    raw_output: str
    # time-stamped spans (runtime/longform.Segment) with word times, set
    # by transcribe()
    segments: Optional[list] = None


class AsrEngine:
    """Loads a Qwen3-ASR checkpoint and transcribes audio files."""

    def __init__(
        self,
        model_dir: str | Path | None,
        dtype: torch.dtype = torch.bfloat16,
        max_new_tokens: int = 4096,
        chunk_buckets: Sequence[int] = DEFAULT_CHUNK_BUCKETS,
        config: Optional[AsrConfig] = None,
        params: Optional[tuple] = None,
        tokenizer=None,
        device: str | torch.device = "cuda",
        quantize: Optional[str] = None,
        kv_dtype: Optional[str] = None,
        mesh=None,
        speculative: Optional[str] = None,
        spec_k: int = 4,
        draft_model=None,
    ):
        """``params``: optional (encoder, decoder) trees (torch tensors or
        numpy arrays in the JAX layouts), cast to ``dtype`` on ``device``.
        ``device`` is explicit: there is no CPU fallback for "cuda".
        ``quantize``: None, 'int8', 'int4', 'int4g' (group-wise int4 with
        ``ASR_INT4_GROUP`` rows per group, default 128) or 'lm8' (int8
        lm_head only), applied to the decoder weights after the cast to
        ``dtype``, as the JAX engine does; on CUDA an int4g group size the
        decode kernel does not take raises ValueError here. ``kv_dtype``:
        None (``ASR_KV``, else 'bf16'), 'bf16' (slabs in ``dtype``) or
        'int8' (int8 slabs with per-slot scales: half the slab bytes per
        decode step). ``mesh``: a ('dp', 'tp') ``DeviceMesh``
        (``parallel.make_mesh``) on whose ranks the engine runs SPMD (see
        the module docstring); ``device`` is then this rank's.

        ``speculative``: draft-and-verify decoding of B = 1 transcriptions
        (greedy: output equal to plain greedy's; sampled: speculative
        sampling). It names the draft's precision, 'int4' | 'int4g' |
        'int8' | 'lm8' | 'bf16', a copy of this checkpoint's decoder
        quantized so ('bf16': the decoder before ``quantize``, a
        self-draft that accepts everything). ``spec_k``: drafts per
        verify (>= 1). ``draft_model``: a smaller checkpoint drafting (a
        directory, or an ``(AsrConfig, (enc, dec))`` tuple), with its own
        encoder and slab; ``speculative`` then names its quantization
        (None: as loaded). Its vocabulary and audio-token layout must be
        the target's."""
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("AsrEngine(device='cuda'): no CUDA device")
        model_dir = Path(model_dir) if model_dir is not None else None
        if config is None:
            config = AsrConfig.from_file(model_dir / "config.json")
        self.config = config
        self.dtype = dtype
        self.max_new_tokens = max_new_tokens
        self.chunk_buckets = tuple(sorted(chunk_buckets))
        if speculative or draft_model:
            require(config.text, "speculative decoding")
        if quantize:
            require(config.text, "quantized weights", f"quantize={quantize!r}")
        # a cross-model draft: ``speculative`` names its quantization
        draft_quant = None
        if draft_model is not None:
            _check_spec(mesh, spec_k)
            draft_quant = speculative or "bf16"
            speculative = None
        if speculative is not None:
            _check_spec(mesh, spec_k)
        tp_size = mesh_dims(mesh)[1]
        if tp_size > 1:
            require(config.text, "tensor parallelism")
        self.mesh = mesh
        self._dp, self._tp = mesh_axis(mesh, "dp"), mesh_axis(mesh, "tp")
        if tp_size > 1 and quantize in ("int4g", "lm8"):
            raise ValueError(
                f"quantize={quantize!r} is not supported under tensor "
                "parallelism (works on dp-only meshes)"
                + ("; use int8" if quantize == "int4g" else ""))
        if params is None:
            logger.info("Loading weights from %s", model_dir)
            params = load_model_params(model_dir, config, dtype, self.device)
        else:
            params = to_torch(params, dtype, self.device)
        self.enc_params, self.dec_params = params
        del params  # so the float linears are freed once quantized
        self.quantize = quantize
        self.spec_k = int(spec_k)
        gsize = int(os.environ.get("ASR_INT4_GROUP", "128"))
        if quantize == "int4g":
            self._check_group(config, gsize)
        base_dec = self.dec_params
        self.dec_params = self._quantize_params(self.dec_params, quantize,
                                                gsize, tp_size)
        # same-checkpoint draft weights, from the decoder before quantize
        self.draft_params = (None if speculative is None else
                             self._build_draft_params(base_dec, speculative))
        del base_dec
        if kv_dtype is None:
            kv_dtype = os.environ.get("ASR_KV")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        if kv_dtype == "int8" and tp_size > 1:
            raise ValueError(
                "kv_dtype='int8' is not supported under tensor "
                "parallelism (works on dp-only meshes)")
        self.kv_quant = kv_dtype == "int8"
        if self.kv_quant:
            require(config.text, "int8 cache", "kv_dtype='int8'")
        if mesh is not None:
            self.enc_params = shard_params(
                self.enc_params, mesh,
                encoder_param_specs(config.audio.encoder_attention_heads,
                                    tp_size))
            self.dec_params = shard_params(
                self.dec_params, mesh,
                quantized_decoder_param_specs() if quantize == "int8" else
                int4_decoder_param_specs() if quantize == "int4" and
                tp_size > 1 else decoder_param_specs())
        if tokenizer is None:
            tokenizer = AsrTokenizer.from_dir(model_dir)
        self.tokenizer = tokenizer

        self.mel_filters = torch.from_numpy(
            create_mel_filterbank(config.audio.num_mel_bins)
        ).to(self.device)
        self.encoder = AudioEncoder(config.audio, device=self.device,
                                    tp=self._tp)
        spec = speculative is not None or draft_model is not None
        max_pos = 16
        for c in self.chunk_buckets:
            max_pos = max(max_pos, self._prompt_bucket(c) + max_new_tokens + 8
                          + (self._spec_slack() if spec else 0))
        self.decoder = decoder_class(config.text)(
            config.text, max_position=max_pos, device=self.device,
            tp=self._tp)
        self.draft_bundle = (
            None if draft_model is None else
            self._build_draft_bundle(draft_model, draft_quant, max_pos))
        # the last speculative call's iterations, tokens and mean accepted
        # drafts per iteration (None before the first)
        self.last_spec_stats = None
        # decode steps per non-blocking read of the done flags
        self.decode_chunk = 4
        # on CUDA, replay each decode step as a captured CUDA graph (False
        # runs the same step eagerly: the card checks compare the two)
        self.cuda_graphs = True
        self._states: dict = {}   # B -> _DecodeState
        self._arenas: dict = {}   # B -> the first stage's slab storage
        self._graphs: dict = {}   # _graph_key -> the first stage's StepGraph
        self._side = self._pool = None  # capture stream, graph memory pool
        # (slab length, max_new) -> streaming's slab leases and graphs
        # (runtime/streaming.py::_StreamGraphs)
        self._stream_graphs: dict = {}
        # step counts, slab lengths and stage times of the last call
        self.last_stats: dict = {}

    def _check_group(self, config: AsrConfig, gsize: int) -> None:
        """On CUDA, refuse an int4g group size the decode kernel does not
        take for ``config``'s projections."""
        t = config.text
        ks = (t.hidden_size, t.num_attention_heads * t.head_dim,
              t.intermediate_size)
        if self.device.type == "cuda" and not int4g_group_supported(gsize, ks):
            raise ValueError(
                f"ASR_INT4_GROUP={gsize}: the CUDA decode kernel takes int4 "
                "group sizes 32, 64 and multiples of 128 that divide every "
                f"projection's input width {ks}")

    def _build_draft_params(self, base_dec, mode: str, config=None):
        """Draft decoder weights for speculative decoding (JAX
        ``_build_draft_params``): 'bf16' keeps ``base_dec``, the others
        quantize it with merged projections (int4g at ``ASR_INT4_GROUP``
        rows per group), 'lm8' the lm_head only. ``config``: the draft's
        (default the target's), for int4g's group check."""
        if mode == "bf16":
            return base_dec
        if mode == "int4g":
            gsize = int(os.environ.get("ASR_INT4_GROUP", "128"))
            self._check_group(config or self.config, gsize)
            return quantize_decoder_params(base_dec, bits=4, merge=True,
                                           group_size=gsize)
        if mode in ("int8", "int4"):
            return quantize_decoder_params(
                base_dec, bits=4 if mode == "int4" else 8, merge=True)
        if mode == "lm8":
            return quantize_lm_head_only(base_dec)
        raise ValueError(
            f"unknown speculative draft mode {mode!r} "
            "(expected int4 | int4g | int8 | lm8 | bf16)")

    def _build_draft_bundle(self, draft_model, draft_quant: str,
                            max_pos: int) -> DraftBundle:
        """Load and validate a cross-model draft (JAX
        ``_build_draft_bundle``): a model directory, or an ``(AsrConfig,
        (enc, dec))`` tuple. Its vocabulary and audio-token layout must be
        the target's: the verify compares token ids, and one prompt with
        one run of audio tokens serves both models."""
        if isinstance(draft_model, tuple):
            dcfg, (denc, ddec) = draft_model
        else:
            ddir = Path(draft_model)
            dcfg = AsrConfig.from_file(ddir / "config.json")
            denc = ddec = None
        cfg = self.config
        require(dcfg.text, "speculative decoding")
        if dcfg.text.vocab_size != cfg.text.vocab_size:
            raise ValueError(
                f"draft vocab_size {dcfg.text.vocab_size} != target "
                f"{cfg.text.vocab_size}: speculative tokens would not be "
                "comparable")
        for field in ("num_mel_bins", "chunk_frames", "tokens_per_chunk",
                      "n_window_infer"):
            dv, tv = getattr(dcfg.audio, field), getattr(cfg.audio, field)
            if dv != tv:
                raise ValueError(
                    f"draft audio {field}={dv} != target {tv}: the models "
                    "would disagree on the audio-token layout")
        if denc is None:
            logger.info("Loading draft weights from %s", ddir)
            denc, ddec = load_model_params(ddir, dcfg, self.dtype,
                                           self.device)
        else:
            denc, ddec = to_torch((denc, ddec), self.dtype, self.device)
        if draft_quant not in (None, "bf16"):
            ddec = self._build_draft_params(ddec, draft_quant, dcfg)
        return DraftBundle(
            config=dcfg,
            encoder=AudioEncoder(dcfg.audio, device=self.device),
            decoder=decoder_class(dcfg.text)(dcfg.text, max_position=max_pos,
                                             device=self.device),
            enc_params=denc, dec_params=ddec)

    def _spec_active(self, batch: int) -> bool:
        """Speculative decoding runs single streams (JAX ``_spec_active``):
        a batch already shares one weight stream among its rows, and
        per-row acceptance would break the shared write slot, so B > 1
        keeps the plain loop. Greedy and sampled calls both take it."""
        return (self.draft_params is not None
                or self.draft_bundle is not None) and batch == 1

    def _spec_slack(self) -> int:
        """Slots past a stage's cap that a speculative slab carries: k + 1
        for an iteration's block (JAX's slack), and k + 1 more for an
        iteration replayed after the stream stopped (its writes land past
        the live slots and are masked out of the state)."""
        return 2 * (self.spec_k + 1)

    @staticmethod
    def _quantize_params(dec, quantize: Optional[str], gsize: int = 128,
                         tp: int = 1):
        """The decoder tree under a weight-quantization mode (the JAX
        engine's ``_quantize_params``); ``gsize``: int4g's rows per scale
        group; ``tp`` > 1: the projections stay unmerged (the specs shard
        them by name) and int4 packs block-locally per tp shard."""
        if quantize is None:
            return dec
        if quantize in ("int8", "int4"):
            logger.info("Quantizing decoder weights to %s", quantize)
            merge = tp == 1 and os.environ.get("ASR_MERGE_QKV", "1") != "0"
            return quantize_decoder_params(
                dec, bits=4 if quantize == "int4" else 8, merge=merge,
                tp_blocks=tp if quantize == "int4" else 1)
        if quantize == "lm8":
            logger.info("Quantizing lm_head to int8 (layers keep their dtype)")
            return quantize_lm_head_only(dec)
        if quantize == "int4g":
            logger.info("Quantizing decoder weights to int4 (group size %d)",
                        gsize)
            merge = os.environ.get("ASR_MERGE_QKV", "1") != "0"
            return quantize_decoder_params(dec, bits=4, merge=merge,
                                           group_size=gsize)
        raise ValueError(f"unknown quantize mode {quantize!r}")

    def _prompt_bucket(self, num_chunks: int) -> int:
        tpc = self.config.audio.tokens_per_chunk
        p = AUDIO_OFFSET + num_chunks * tpc + PROMPT_SLACK
        return -(-p // 16) * 16

    def _chunk_bucket(self, samples_list: Sequence[np.ndarray]) -> int:
        """The chunk bucket that utterances share: the largest any needs."""
        return max(self._pick_bucket(num_mel_frames(len(s)))
                   for s in samples_list)

    def _pick_bucket(self, n_frames: int) -> int:
        cf = self.config.audio.chunk_frames
        chunks_needed = -(-n_frames // cf)
        for c in self.chunk_buckets:
            if c >= chunks_needed:
                return c
        raise ValueError(
            f"audio needs {chunks_needed} chunks, exceeding the largest "
            f"bucket {self.chunk_buckets[-1]}; use transcribe() which "
            "segments long audio"
        )

    @property
    def max_bucket_seconds(self) -> float:
        cf = self.config.audio.chunk_frames
        return self.chunk_buckets[-1] * cf * 160 / 16000

    def _segment_caps(self) -> list[int]:
        """Token caps of the decode stages (the JAX engine's segmented
        slab): ``ASR_DECODE_SEGMENT`` tokens (default 256), then 4x per
        stage, the last at ``max_new_tokens``."""
        max_new = self.max_new_tokens
        seg = max(1, min(int(os.environ.get("ASR_DECODE_SEGMENT", "256")),
                         max_new))
        caps = []
        while True:
            caps.append(min(seg, max_new))
            if seg >= max_new:
                return caps
            seg *= 4

    def _slab_len(self, p_bucket: int, cap: Optional[int] = None) -> int:
        """Slots of a slab for prompt bucket P and a stage of ``cap`` tokens
        (default: ``max_new_tokens``), rounded up to 8 slots."""
        cap = self.max_new_tokens if cap is None else cap
        return -(-(p_bucket + cap + 1) // 8) * 8

    def _new_cache(self, batch: int, p_bucket: int) -> KVCache:
        """A fresh zero slab of the full length, of the decoder's cache
        type: the slab of ``prefill`` and ``prefill_batch`` when the
        caller passes none."""
        return self.decoder.cache_type.zeros(
            self.decoder.cfg, batch, self._slab_len(p_bucket),
            dtype=self.dtype, device=self.device, quantized=self.kv_quant)

    @torch.inference_mode()
    def _embed_prompts(self, samples_list: Sequence[np.ndarray],
                       languages: Sequence[Optional[str]], aligned: bool,
                       draft: Optional[DraftBundle] = None):
        """Mel, encoder and prompt embedding with audio injection for
        utterances that share one chunk bucket (the largest any needs),
        as the JAX engine's ``vmap``: one host loop (padding, prompt ids),
        one copy to the device, one batched log-mel and one batched
        encoder call over every row (the draft's encoder once more).
        Prompts sit at slots [0, len) or, ``aligned``, end at the prompt
        bucket P; each row's audio goes to its prompt start +
        ``AUDIO_OFFSET``. Returns (hidden (B, P, H), true prompt lengths,
        the ``draft`` model's own embeddings of the same ids and mel with
        its own encoder's audio injected, or None)."""
        with span("prefill.encode"):
            cfg = self.config
            cf = cfg.audio.chunk_frames
            bucket_chunks = self._chunk_bucket(samples_list)
            p_bucket = self._prompt_bucket(bucket_chunks)
            b = len(samples_list)
            ids = torch.zeros((b, p_bucket), dtype=torch.long)
            n_true = np.zeros(b, np.int64)
            runs, true_lens = [], []
            # pad_waveform's output at the bucket: each row padded at its
            # true length, then zeros (a third of the host's copies);
            # pinned on CUDA, so that its copy does not hold the host
            waves = torch.empty((b, bucket_chunks * cf * 160 + 400),
                                pin_memory=self.device.type == "cuda")
            host = waves.numpy()
            # the blocking copies precede the call's device work: each
            # waits for the card
            with span("prefill.mel"):
                for i, (samples, language) in enumerate(zip(samples_list,
                                                            languages)):
                    wave, n = pad_waveform(samples)
                    host[i, :len(wave)] = wave
                    host[i, len(wave):] = 0.0
                    n_true[i] = n
                    n_audio = audio_tokens(cfg.audio, n)
                    prompt = build_prompt(n_audio, language, self.tokenizer)
                    if len(prompt) > p_bucket:
                        raise ValueError(
                            "prompt exceeds bucket; language string too long")
                    start = p_bucket - len(prompt) if aligned else 0
                    ids[i, start: start + len(prompt)] = torch.tensor(prompt)
                    true_lens.append(len(prompt))
                    runs.append((start + AUDIO_OFFSET, n_audio))
                ids = ids.to(self.device)
                n_true = torch.from_numpy(n_true).to(self.device)
                mel = log_mel_from_padded(
                    waves.to(self.device, non_blocking=True), n_true,
                    self.mel_filters)
            models = [(self.encoder, self.enc_params, self.decoder,
                       self.dec_params)]
            if draft is not None:
                models.append((draft.encoder, draft.enc_params,
                               draft.decoder, draft.dec_params))
            with span("prefill.encoder"):
                audio = [enc.batch(enc_params, mel, n_true)[0]
                         for enc, enc_params, _, _ in models]
            hidden = []
            for (_, _, dec, dec_params), embeds in zip(models, audio):
                h = dec.embed(dec_params, ids)
                for i, (at, n_audio) in enumerate(runs):
                    h[i, at: at + n_audio] = embeds[i, :n_audio].to(h.dtype)
                hidden.append(h)
            return (hidden[0], true_lens,
                    hidden[1] if draft is not None else None)

    @torch.inference_mode()
    def prefill(self, samples: np.ndarray, language: Optional[str] = None,
                cache: Optional[KVCache] = None, counts=None):
        """Mel, encoder, prompt injection and prefill for one utterance,
        into ``cache`` (a slab of at least the prompt bucket's slots;
        default ``_new_cache``); ``counts``: the decoder's per-call
        counters (``_DecodeState.counts``). Returns (logits (1, V) at the
        last prompt token, KV cache, true prompt length)."""
        hidden, (true_len,), _ = self._embed_prompts([samples], [language],
                                                     aligned=False)
        p_bucket = hidden.shape[1]
        if cache is None:
            cache = self._new_cache(1, p_bucket)
        with span("prefill.decoder"):
            logits, cache = self.decoder.prefill(
                self.dec_params, hidden,
                torch.arange(p_bucket, device=self.device), cache, true_len,
                counts=counts)
        return logits, cache, true_len

    @torch.inference_mode()
    def prefill_batch(self, samples_list: Sequence[np.ndarray],
                      languages: Sequence[Optional[str]],
                      cache: Optional[KVCache] = None, counts=None):
        """Mel, encoder, prompt injection and right-aligned prefill for B
        utterances into ``cache`` (default ``_new_cache``; ``counts`` as
        ``prefill``'s): row b's prompt spans slots [kv_start_b, P).
        Returns (logits (B, V) at slot P - 1, KV cache, kv_start (B,)
        int32, P)."""
        hidden, true_lens, _ = self._embed_prompts(samples_list, languages,
                                                   aligned=True)
        b, p_bucket = hidden.shape[:2]
        # a blocking copy would wait for the encoder on the card
        kv_start = torch.tensor([p_bucket - n for n in true_lens],
                                dtype=torch.int32).to(self.device,
                                                      non_blocking=True)
        if cache is None:
            cache = self._new_cache(b, p_bucket)
        with span("prefill.decoder"):
            logits, cache = self.decoder.prefill_aligned(
                self.dec_params, hidden, kv_start, cache, counts=counts)
        return logits, cache, kv_start, p_bucket

    def _slab0(self, b: int, n: int, key=None, decoder=None) -> KVCache:
        """The first stage's ``n``-slot slab for B = ``b``: a view of the
        first elements of the arena kept under ``key`` (default B; the
        speculative loop's are ("spec", "target") and ("spec", "draft"),
        of ``decoder``'s cache type at its widths, default the target's),
        so that a captured step keeps its address from call to call. A
        longer slab than the arena holds replaces the arena and every
        arena and graph of its group (``_release``)."""
        key = b if key is None else key
        decoder = self.decoder if decoder is None else decoder
        cache_type = decoder.cache_type
        shapes = cache_type.slab_shapes(decoder.cfg, b, n, self.dtype,
                                        self.kv_quant)
        arena = self._arenas.get(key)
        if arena is None or arena[0].numel() < math.prod(shapes[0][0]):
            if arena is not None:  # replaced: its group's graphs go too
                self._release(_group(key))
            arena = [torch.zeros(math.prod(shape), dtype=dt,
                                 device=self.device) for shape, dt in shapes]
            self._arenas[key] = arena
        return cache_type(*(t[:math.prod(shape)].view(shape)
                            for t, (shape, _) in zip(arena, shapes)))

    def _release(self, group=None) -> None:
        """Free a group's first-stage arenas and the graphs captured on
        them: a B's (``group`` = B), the speculative loop's ("spec"), or
        with None every group's."""
        self._arenas = {k: a for k, a in self._arenas.items()
                        if group is not None and _group(k) != group}
        self._graphs = {k: g for k, g in self._graphs.items()
                        if group is not None and k[0] != group}
        self._drop_dead_pool()

    def _drop_dead_pool(self) -> None:
        """Forget the graph memory pool once no kept graph uses it: a pool
        whose graphs are all gone may not take a capture again (a PyTorch
        allocator assert), so the next capture takes a new one."""
        if not any(g.pool == self._pool for g in self._graphs.values()):
            self._pool = None

    def _state(self, b: int) -> "_DecodeState":
        if b not in self._states:
            self._states[b] = _DecodeState.zeros(b, self.max_new_tokens,
                                                 self.device, self.decoder)
        return self._states[b]

    def _step_fn(self, st: "_DecodeState", cache: KVCache, aligned: bool,
                 sampling: SamplingParams):
        """One decode step over the device state (the body of the JAX
        engine's loop, ``engine.py:731-771``): step ``st.step`` writes slot
        ``st.base + st.step`` (base: the prompt length, or the prompt
        bucket P of a right-aligned batch), and its token, the greedy one
        or JAX's draw at ``fold_in(st.key, step + 1)``, is appended."""
        dec, params = self.decoder, self.dec_params
        sample = not sampling.greedy
        kw = {"counts": st.counts}

        def step():
            slot = st.base + st.step
            if sample:  # the logits variant, never the fold, as in JAX
                if aligned:
                    logits, _ = dec.decode_step_aligned(
                        params, st.tok, slot, st.kv_start, cache, **kw)
                else:
                    logits, _ = dec.decode_step(params, st.tok, slot, cache,
                                                **kw)
                tok = sample_token(logits, KeyChain(st.key, ((st.step, 1),)),
                                   st.temp, sampling.top_k, sampling.top_p)
            elif aligned:
                tok, _ = dec.decode_step_aligned_token(
                    params, st.tok, slot, st.kv_start, cache, **kw)
            else:
                tok, _ = dec.decode_step_token(params, st.tok, slot, cache,
                                               **kw)
            st.append(tok)
            st.step.add_(1)

        return step

    def _graph_key(self, b: int, cache: KVCache, aligned: bool,
                   sampling: SamplingParams) -> tuple:
        """What a captured first-stage step depends on: B, the slab length,
        the layout, greedy or sampled with its static filters, and the
        environment switches that the step reads while it is captured."""
        return (b, cache.max_len, aligned, _variant(sampling), _env_key())

    def _capture(self, fn) -> StepGraph:
        """Run ``fn`` once eagerly on the capture stream (a real decode
        step: it creates the wrappers' per-stream scratch), then capture
        it into the engine's graph memory pool. Returns the graph."""
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return capture(fn, self._side, self._pool)

    @torch.inference_mode()
    def _generate(self, samples_list: Sequence[np.ndarray],
                  languages: Sequence[Optional[str]], live: np.ndarray,
                  sampling: Optional[SamplingParams] = None,
                  warmup: bool = False, aligned: Optional[bool] = None,
                  dp_rank: Optional[int] = None) -> list[list[int]]:
        """Token ids (EOS excluded) for B utterances: one prefill (B = 1
        ``prefill``, else ``prefill_batch``) into the first stage's slab
        and the decode loop on device state. Rows with ``live`` False are
        born done and emit nothing. ``aligned`` (default B > 1) and
        ``dp_rank``: a dp rank's rows, right-aligned as rows of the whole
        batch, drawing with ``fold_in(key, dp_rank)`` (JAX's shard_map).

        The loop runs in stages of growing slabs (``_segment_caps``),
        each of up to cap - 1 decode steps (max_new_tokens - 1 in all);
        a stage grows the slab into the next one (``KVCache.grow``) and is
        skipped once every row is done. Steps run in chunks of
        ``decode_chunk`` (4); after each chunk one non-blocking read of
        the done flags is enqueued, and the host waits for a chunk's flags
        only after it has enqueued the next chunk. On CUDA each step is a
        replay of a CUDA graph (one eager step on the capture stream
        first): the first stage's graphs are kept per ``_graph_key`` with
        its slab (``_slab0``); a call that leaves the first stage frees
        them (``_release``), and captures its later stages' graphs, which
        go with their slabs at its end. With ``cuda_graphs`` False, or on
        the CPU, the same step runs eagerly. ``warmup``: the first stage's
        graph is captured and nothing is replayed.

        Fills ``last_stats``: ``decode_steps`` (steps run, eager and
        replayed), ``replays``, ``captures``, ``steps_past_done`` (steps
        run after the step that made every row done), ``slab_lens`` (the
        stages' slab lengths), ``n_gen`` (tokens per row),
        ``prefill_seconds`` (host clock up to the first token,
        synchronized), ``decode_seconds`` (host clock of the loop, to its
        one read of the tokens) and, on CUDA, ``decode_gpu_seconds`` (the
        GPU's elapsed time over the same loop, between CUDA events: the
        card's busy time plus any time the host left it idle), and what
        the decoder's per-call counters add (``read_counts``).
        """
        sampling = normalize(sampling)
        live = np.asarray(live, bool)
        b = len(samples_list)
        if self._spec_active(b):
            return [self._spec_generate(samples_list[0], languages[0],
                                        bool(live[0]), sampling, warmup)]
        t0 = time.perf_counter()
        p = self._prompt_bucket(self._chunk_bucket(samples_list))
        caps = self._segment_caps()
        st = self._state(b)
        cache = self._slab0(b, self._slab_len(p, caps[0]))
        aligned = b > 1 if aligned is None else aligned
        if aligned:
            logits, _, kv_start, _ = self.prefill_batch(
                samples_list, languages, cache, st.counts)
            st.kv_start.copy_(kv_start)
            base = p
        else:
            logits, _, base = self.prefill(samples_list[0], languages[0],
                                           cache, st.counts)
        # the reset copies ``live`` from the host with a blocking copy,
        # which waits for the prefill on the card
        with span("wait.prefill"):
            st.start(live, base, sampling, dp_rank)
        if sampling.greedy:
            tok0 = torch.argmax(logits, dim=-1)
        else:  # the prefill's token: fold_in(key, 0)
            tok0 = sample_token(logits, KeyChain(st.key, (0,)), st.temp,
                                sampling.top_k, sampling.top_p)
        st.append(tok0)
        cuda = self.device.type == "cuda"
        # tp steps run eagerly: their collectives are not captured
        graphs = cuda and self.cuda_graphs and self._tp is None
        if cuda:
            with span("wait.prefill"):
                torch.cuda.synchronize(self.device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t_first = time.perf_counter()

        flags = _DoneFlags(self.device)
        # decode steps: one per token but the prefill's
        total = self.max_new_tokens - 1
        steps = replays = captures = 0
        all_done = not live.any()
        slab_lens = [cache.max_len]
        try:
            for i, cap in enumerate(caps):
                if i > 0:
                    if all_done:
                        break
                    cache = cache.grow(self._slab_len(p, cap))
                    if i == 1:
                        self._release(b)
                    slab_lens.append(cache.max_len)
                stop = min(cap, total)
                if steps >= stop or (all_done and not warmup):
                    continue
                fn = self._step_fn(st, cache, aligned, sampling)
                graph = None
                if graphs:  # the first stage's graphs are kept
                    key = (self._graph_key(b, cache, aligned, sampling)
                           if i == 0 else None)
                    graph = self._graphs.get(key)
                    if graph is None:
                        graph = self._capture(fn)
                        captures += 1
                        steps += 1
                        if key is not None:
                            self._graphs[key] = graph
                if warmup:
                    continue
                run = fn if graph is None else graph.replay
                pending = None
                while steps < stop:
                    n = min(self.decode_chunk, stop - steps)
                    for _ in range(n):
                        run()
                    steps += n
                    replays += n if graph is not None else 0
                    posted = flags.post(st.done)
                    if pending is not None and flags.read(pending):
                        all_done = True
                        break
                    pending = posted
                else:
                    if pending is not None:
                        all_done = flags.read(pending)
        finally:  # the later stages' graphs go with this call
            self._drop_dead_pool()
        if cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        with span("wait.read_out"):
            n_gen = st.n_gen.tolist()
            out_buf = st.out_buf.cpu()
            done = st.done.tolist()
            counted = self.decoder.read_counts(st.counts, steps)
        t_end = time.perf_counter()
        # decode steps each row needed: its EOS is token n_gen (the step
        # n_gen - 1 made it); a row without one needed every step
        need = [g if d else total
                for g, d, lv in zip(n_gen, done, live) if lv]
        self.last_stats = {
            "decode_steps": steps,
            "replays": replays,
            "captures": captures,
            "steps_past_done": max(steps - max(need, default=0), 0),
            "slab_lens": slab_lens,
            "prefill_seconds": t_first - t0,
            "decode_seconds": t_end - t_first,
            "n_gen": n_gen,
        }
        if cuda:
            self.last_stats["decode_gpu_seconds"] = (
                ev0.elapsed_time(ev1) / 1e3)
        self.last_stats.update(counted)
        return [out_buf[i, :g].tolist() for i, g in enumerate(n_gen)]

    def _spec_state(self) -> "_SpecState":
        if "spec" not in self._states:
            self._states["spec"] = _SpecState.zeros(
                self.max_new_tokens, self.spec_k, self.device)
        return self._states["spec"]

    def _spec_draft(self):
        """(decoder, params) of the draft."""
        if self.draft_bundle is not None:
            return self.draft_bundle.decoder, self.draft_bundle.dec_params
        return self.decoder, self.draft_params

    def _spec_iteration(self, st: "_SpecState", cache: KVCache,
                        dcache: KVCache, sampling: SamplingParams):
        """One draft-and-verify iteration over the device state (the body
        of JAX's ``_spec_decode_loop``, ``engine.py:887-1021``, and of
        ``_spec_sample_loop``, ``:1023-1152``). The pending token ``tok``
        sits at slot pos = base + step. The draft decodes k + 1 tokens
        from it over its slab (greedy steps, or sampled from its filtered
        distributions q_i, step i at JAX's ``fold_in(key_it, 2 + i)``, key_it
        = ``fold_in(key, iters + 1)``); the k + 1
        steps keep the draft slab's slot pos + k valid when all k drafts
        are accepted. The target scores [tok, d_1..d_k] at pos
        (``score_chunk``). Greedy: the longest prefix with d_i equal to
        the target's argmax t_i is accepted, the candidates [tok,
        t_1..t_k] are emitted up to the accepted count, truncated before
        the first EOS and clamped to max_new tokens in all, and t_{acc+1}
        becomes the pending token. Sampled: ``speculative_accept`` on the
        target's filtered distributions p_i, candidates [tok, d_1..d_k],
        its replacement or bonus token pending. The window goes to
        out_buf at n_gen by one scatter.

        The iteration is masked unless the stream is live (not done) and
        below the stage's cap: a masked one leaves tok, n_gen, out_buf,
        step, the counts and done as they were, and its slab writes land
        at slots past the live ones (``_spec_slack``), so that replays
        after the stream stopped change nothing. ``stop`` (done or at the
        cap) is what the host reads."""
        k = self.spec_k
        dec, params = self.decoder, self.dec_params
        d_dec, d_params = self._spec_draft()
        sample = not sampling.greedy
        top_k, top_p = sampling.top_k, sampling.top_p
        idx = torch.arange(k + 1, device=self.device)
        max_new = self.max_new_tokens

        def iteration():
            active = ~st.done[0] & (st.step < st.cap)
            pos = st.base + st.step
            key_it = (st.iters, 1)  # fold_in(key, iters + 1)
            tok, drafts, q = st.tok, [], []
            for i in range(k + 1):
                if sample:
                    logits, _ = d_dec.decode_step(d_params, tok, pos + i,
                                                  dcache)
                    q.append(filtered_probs(logits[0], st.temp, top_k, top_p))
                    tok = sample_token(
                        logits, KeyChain(st.key, (key_it, 2 + i)), st.temp,
                        top_k, top_p)
                else:
                    tok, _ = d_dec.decode_step_token(d_params, tok, pos + i,
                                                     dcache)
                drafts.append(tok.long())
            drafts = torch.cat(drafts[:k])
            block = torch.cat([st.tok, drafts])
            if sample:
                logits, _ = dec.score_chunk(params, block[None], pos, cache,
                                            return_logits=True)
                acc, nxt = speculative_accept(
                    KeyChain(st.key, (key_it, 0)), drafts, torch.stack(q[:k]),
                    filtered_probs(logits[0], st.temp, top_k, top_p))
                cand, nxt = block, nxt.reshape(1)
            else:
                t, _ = dec.score_chunk(params, block[None], pos, cache)
                t = t[0].long()
                acc = torch.cumprod((drafts == t[:k]).long(), 0).sum()
                cand = torch.cat([st.tok, t[:k]])
                nxt = t.gather(0, acc.reshape(1))
            eos = (cand == EOS_TOKEN_IDS[0]) | (cand == EOS_TOKEN_IDS[1])
            n_raw = (torch.cumprod((~eos).long(), 0) * (idx <= acc)).sum()
            n_emit = torch.where(
                active, torch.minimum(n_raw, max_new - st.step), 0)
            cols = st.n_gen + idx
            row = st.out_buf[0]
            row.scatter_(0, cols, torch.where(active, cand,
                                              row.gather(0, cols)))
            st.n_gen.add_(n_emit)
            st.step.add_(n_emit)
            st.tok.copy_(torch.where(active, nxt, st.tok))
            st.done.logical_or_(active & (n_raw < acc + 1))
            st.iters.add_(active.long())
            st.accepted.add_(torch.where(active, acc, 0))
            st.stop.copy_(st.done | (st.step >= st.cap))

        return iteration

    @torch.inference_mode()
    def _spec_generate(self, samples: np.ndarray, language: Optional[str],
                       live: bool, sampling: SamplingParams,
                       warmup: bool = False) -> list[int]:
        """Token ids (EOS excluded) of one utterance by speculative
        decoding (see ``_spec_iteration``): the target and the draft each
        prefill their first-stage slab (views of the arenas ("spec",
        "target") and ("spec", "draft"), sized by ``_spec_slab_len``),
        the draft from its own embeddings when it is another model, from
        the target's otherwise (JAX shares them); the prefill's token is
        the argmax or draw 0. Stages as in ``_generate``: both slabs grow
        together (``KVCache.grow``, each at its own widths) once a stage
        stops at its cap with the stream live. Iterations run in chunks
        of ``decode_chunk`` with one non-blocking read of ``stop`` per
        chunk; on CUDA each is a replay of one CUDA graph (the first
        stage's kept with its arenas under ``("spec", ...)``), with
        ``cuda_graphs`` False or on the CPU the same function runs
        eagerly. ``live`` False (warmup): born done; ``warmup`` captures
        the first stage's graph and replays nothing.

        Fills ``last_spec_stats`` (JAX's: iterations, tokens, mean
        accepted drafts per iteration = (tokens - iterations) /
        iterations) and ``last_stats``: ``iterations`` and
        ``drafts_accepted`` (device counts of live iterations),
        ``iterations_run`` (eager and replayed, masked ones included),
        ``replays``, ``captures``, ``slab_lens``, ``n_gen``,
        ``prefill_seconds``, ``decode_seconds`` and, on CUDA,
        ``decode_gpu_seconds`` (as ``_generate``)."""
        t0 = time.perf_counter()
        p = self._prompt_bucket(self._chunk_bucket([samples]))
        caps = self._segment_caps()
        d_dec, d_params = self._spec_draft()
        n = self._spec_slab_len(p, caps[0])
        cache = self._slab0(1, n, ("spec", "target"))
        dcache = self._slab0(1, n, ("spec", "draft"), d_dec)
        hidden, (true_len,), d_hidden = self._embed_prompts(
            [samples], [language], aligned=False, draft=self.draft_bundle)
        slots = torch.arange(p, device=self.device)
        with span("prefill.decoder"):
            logits, _ = self.decoder.prefill(self.dec_params, hidden, slots,
                                             cache, true_len)
            d_dec.prefill(d_params, hidden if d_hidden is None else d_hidden,
                          slots, dcache, true_len)
        st = self._spec_state()
        with span("wait.prefill"):
            st.start(live, true_len, sampling)
        if sampling.greedy:
            st.tok.copy_(torch.argmax(logits, dim=-1))
        else:  # the prefill's token: fold_in(key, 0)
            st.tok.copy_(sample_token(logits, KeyChain(st.key, (0,)),
                                      st.temp, sampling.top_k,
                                      sampling.top_p))
        cuda = self.device.type == "cuda"
        graphs = cuda and self.cuda_graphs
        if cuda:
            with span("wait.prefill"):
                torch.cuda.synchronize(self.device)
            ev0 = torch.cuda.Event(enable_timing=True)
            ev0.record()
        t_first = time.perf_counter()

        flags = _DoneFlags(self.device)
        runs = replays = captures = 0
        slab_lens = [n]
        try:
            for i, cap in enumerate(caps):
                if i > 0:
                    if bool(st.done[0]):
                        break
                    n = self._spec_slab_len(p, cap)
                    cache, dcache = cache.grow(n), dcache.grow(n)
                    if i == 1:
                        self._release("spec")
                    slab_lens.append(n)
                    if int(st.step) >= cap:
                        continue
                st.cap.fill_(cap)
                fn = self._spec_iteration(st, cache, dcache, sampling)
                graph = None
                if graphs:  # the first stage's graphs are kept
                    key = (("spec", n, _variant(sampling), _env_key())
                           if i == 0 else None)
                    graph = self._graphs.get(key)
                    if graph is None:
                        graph = self._capture(fn)
                        captures += 1
                        runs += 1
                        if key is not None:
                            self._graphs[key] = graph
                if warmup:
                    continue
                run = fn if graph is None else graph.replay
                pending = None
                while True:
                    for _ in range(self.decode_chunk):
                        run()
                    runs += self.decode_chunk
                    replays += self.decode_chunk if graph is not None else 0
                    posted = flags.post(st.stop)
                    if pending is not None and flags.read(pending):
                        break
                    pending = posted
        finally:  # the later stages' graphs go with this call
            self._drop_dead_pool()
        if cuda:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        with span("wait.read_out"):
            n_gen = int(st.n_gen[0])
            out = st.out_buf[0, :n_gen].tolist()
            iters, accepted = int(st.iters), int(st.accepted)
        t_end = time.perf_counter()
        self.last_stats = {
            "iterations": iters, "drafts_accepted": accepted,
            "iterations_run": runs, "replays": replays,
            "captures": captures, "slab_lens": slab_lens,
            "prefill_seconds": t_first - t0,
            "decode_seconds": t_end - t_first, "n_gen": [n_gen],
        }
        if cuda:
            self.last_stats["decode_gpu_seconds"] = (
                ev0.elapsed_time(ev1) / 1e3)
        self.last_spec_stats = {
            "iterations": iters, "tokens": n_gen,
            "mean_accepted": (n_gen - iters) / iters if iters else 0.0}
        return out

    def _spec_slab_len(self, p_bucket: int, cap: int) -> int:
        """Slots of a speculative slab for prompt bucket P and a stage of
        ``cap`` tokens: ``_slab_len``'s with ``_spec_slack`` more."""
        return -(-(p_bucket + cap + 1 + self._spec_slack()) // 8) * 8

    def generate(self, samples: np.ndarray, language: Optional[str] = None,
                 sampling: Optional[SamplingParams] = None) -> list[int]:
        """Token ids (EOS excluded) for one utterance; fills ``last_stats``
        (see ``_generate``)."""
        return self._generate([samples], [language], np.ones(1, bool),
                              sampling)[0]

    def generate_batch(self, samples_list: Sequence[np.ndarray],
                       languages: Sequence[Optional[str]],
                       live: np.ndarray,
                       sampling: Optional[SamplingParams] = None
                       ) -> list[list[int]]:
        """Token ids (EOS excluded) for B > 1 utterances in one
        right-aligned batch (``prefill_batch``); decode step i writes slot
        P + i for every row. Rows with ``live`` False are born done and
        emit no token. Fills ``last_stats`` as ``generate`` does."""
        return self._generate(samples_list, languages, live, sampling)

    def _result(self, generated: list[int],
                language: Optional[str]) -> TranscribeResult:
        raw = self.tokenizer.decode(generated)
        lang, text = parse_asr_output(raw, language is not None)
        return TranscribeResult(text=text, language=lang, raw_output=raw)

    def warmup(self, batch_sizes: Sequence[int] = (1,),
               buckets: Optional[Sequence[int]] = None,
               sampling: Optional[SamplingParams] = None) -> None:
        """Capture the first stage's decode graph of each (bucket, batch
        size) — of the sampled variant with ``sampling``'s static top_k /
        top_p, else the greedy one — so that no request that ends within
        the first stage pays a capture. Each runs the whole path with
        every row born done: the prefill, the first stage's slab and one
        eager step for the capture, and no replay. Buckets go largest
        first, so that each batch size's arena is sized once."""
        if buckets is None:
            buckets = list(self.chunk_buckets)
        cf = self.config.audio.chunk_frames
        for c in sorted(buckets, reverse=True):
            clip = np.zeros(int(c * cf * 160), np.float32)
            for b in batch_sizes:
                with stage_timer(f"warmup_c{c}_b{b}"):
                    self.transcribe_batch([clip] * b, sampling=sampling,
                                          _warmup=True)
                logger.info("warmed bucket %d chunks, batch %d", c, b)

    def transcribe_samples(self, samples: np.ndarray,
                           language: Optional[str] = None,
                           sampling: Optional[SamplingParams] = None
                           ) -> TranscribeResult:
        """Transcribe mono 16 kHz f32 samples (one bucket)."""
        return self.transcribe_batch([samples], [language],
                                     sampling=sampling)[0]

    def transcribe_batch(self, samples_list: list,
                         languages: Optional[list] = None,
                         sampling: Optional[SamplingParams] = None,
                         _warmup: bool = False) -> list:
        """Transcribe a batch of utterances in one prefill and one decode
        loop with per-example EOS (the JAX engine's ``transcribe_batch``):
        the decode step streams the weights once for all rows.

        The batch pads to the next power of two by repeating the last
        utterance; pad rows are born done and emit nothing. A single
        utterance takes the left-aligned B = 1 path. ``sampling``
        (``SamplingParams``) switches the argmax for temperature / top-k /
        top-p sampling on the device; None or temperature <= 0 is greedy.
        ``last_stats["n_gen"]`` holds the token count of every row, pad
        rows included. ``_warmup`` (see ``warmup``): every row born done.
        """
        sampling = normalize(sampling)
        n_real = len(samples_list)
        if n_real == 0:
            return []
        if languages is None:
            languages = [None] * n_real
        if len(languages) != n_real:
            raise ValueError(
                f"languages has {len(languages)} entries for {n_real} "
                "utterances"
            )
        b = 1 << (n_real - 1).bit_length()
        dp = self._dp_size()
        b = -(-b // dp) * dp  # each dp rank takes b / dp rows
        samples_list = list(samples_list) + [samples_list[-1]] * (b - n_real)
        languages = list(languages) + [languages[-1]] * (b - n_real)
        live = (np.arange(b) < n_real) & (not _warmup)
        with stage_timer("device_dispatch"):
            if dp == 1:
                generated = self._generate(samples_list, languages, live,
                                           sampling, warmup=_warmup)
            else:
                generated = self._generate_dp(samples_list, languages, live,
                                              sampling, _warmup)
        logger.info("Generated %s tokens", self.last_stats["n_gen"][:n_real])
        return [self._result(g, lang)
                for g, lang in zip(generated[:n_real], languages)]

    def _dp_size(self) -> int:
        """The mesh's dp size: the batch's rows shard over it (1 without
        a mesh)."""
        return 1 if self._dp is None else self._dp.size

    def _generate_dp(self, samples_list, languages, live, sampling,
                     warmup: bool) -> list[list[int]]:
        """``_generate`` of this dp rank's rows [r n, (r + 1) n) (n = b /
        dp), right-aligned as rows of the whole batch, sampled rows drawing
        with ``fold_in(key, r)`` over the rank's own rows, then
        every rank's tokens gathered in row order: the whole batch's
        tokens on every rank. ``last_stats["n_gen"]`` holds every row's
        count; the rest of ``last_stats`` is this rank's."""
        n = len(samples_list) // self._dp.size
        lo = self._dp.rank * n
        rows = slice(lo, lo + n)
        local = self._generate(samples_list[rows], languages[rows],
                               live[rows], sampling, warmup,
                               aligned=len(samples_list) > 1,
                               dp_rank=self._dp.rank)
        parts = [None] * self._dp.size
        torch.distributed.all_gather_object(parts, local,
                                            group=self._dp.group)
        generated = [g for part in parts for g in part]
        self.last_stats["n_gen"] = [len(g) for g in generated]
        return generated

    def transcribe(self, audio_path: str | Path,
                   language: Optional[str] = None,
                   segment_seconds: Optional[float] = None,
                   overlap_seconds: float = 2.0,
                   sampling: Optional[SamplingParams] = None
                   ) -> TranscribeResult:
        """Transcribe an audio file of any length.

        Audio up to the largest bucket is one dispatch whose result
        carries one segment (with word times) spanning the file. Longer
        audio is transcribed in overlapped segments stitched at the
        transcript level (``runtime/longform.py``). Long-form is greedy
        only: overlap stitching matches the two segments' transcripts at
        the junction, which stochastic decoding would break.
        """
        sampling = normalize(sampling)
        samples = load_audio(audio_path, 16000)
        # clamp to bucket capacity: a larger segment_seconds would cut
        # segments no bucket can hold
        max_seconds = min(segment_seconds or self.max_bucket_seconds,
                          self.max_bucket_seconds)
        if len(samples) <= int(max_seconds * 16000):
            r = self.transcribe_samples(samples, language, sampling=sampling)
            seg = attach_words(
                [Segment(0, 0.0, len(samples) / 16000, r.text)]
                if r.text.strip() else []
            )
            return dataclasses.replace(r, segments=seg)
        if not sampling.greedy:
            raise ValueError(
                "sampling is not supported on long-form audio: overlap "
                "stitching needs deterministic transcripts at segment "
                "junctions (pass sampling=None, or transcribe segments "
                "yourself via transcribe_samples)"
            )
        logger.info("Long-form audio (%.1fs): overlapped segments of %.0fs",
                    len(samples) / 16000, max_seconds)
        return transcribe_long(self, samples, language,
                               segment_seconds=max_seconds,
                               overlap_seconds=overlap_seconds)


def _check_spec(mesh, spec_k) -> None:
    """The JAX engine's checks of a speculative configuration."""
    if mesh is not None:
        raise ValueError(
            "speculative decoding runs the single-stream greedy path; it is "
            "not supported under a device mesh")
    if int(spec_k) < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")


def _variant(sampling: SamplingParams) -> tuple:
    """Greedy, or sampled with its static filters (a graph key part)."""
    if sampling.greedy:
        return ("greedy",)
    return ("sample", sampling.top_k, sampling.top_p)


def _env_key() -> tuple:
    """The environment switches a decode step reads while it is captured."""
    return tuple(os.environ.get(k) for k in (
        "ASR_FOLD_LM", "ASR_DECODE_IMPL", "ASR_DECODE_ATTN"))


def _start_key(key: torch.Tensor, sampling: SamplingParams,
               dp_rank: Optional[int] = None) -> None:
    """A sampled call's base key into the device state: JAX's
    ``PRNGKey(seed)``, under dp ``fold_in`` of the rank (greedy calls draw
    nothing and leave it)."""
    if sampling.greedy:
        return
    k = prng_key(sampling.seed)
    key.copy_(k if dp_rank is None else fold_in(k, dp_rank))


@dataclasses.dataclass
class _SpecState:
    """The speculative loop's device state (B = 1), at fixed addresses:
    the pending token, tokens emitted (n_gen == step), done and stop
    flags, the token buffer with k + 1 columns of slack for the last
    window, the live iterations and accepted drafts, and the per-call
    inputs (the prompt length base, the stage's cap, the sampling key and
    temperature)."""

    tok: torch.Tensor       # (1,) int64
    n_gen: torch.Tensor     # (1,) int64
    done: torch.Tensor      # (1,) bool
    stop: torch.Tensor      # (1,) bool: done, or at the stage's cap
    out_buf: torch.Tensor   # (1, max_new + k + 1) int64
    step: torch.Tensor      # () int64, tokens emitted
    iters: torch.Tensor     # () int64, live iterations
    accepted: torch.Tensor  # () int64, accepted drafts
    base: torch.Tensor      # () int64
    cap: torch.Tensor       # () int64
    key: torch.Tensor       # (2,) int64, prng_key(seed)
    temp: torch.Tensor      # () float32

    @classmethod
    def zeros(cls, max_new: int, k: int, device) -> "_SpecState":
        i64 = dict(dtype=torch.int64, device=device)
        flag = dict(dtype=torch.bool, device=device)
        return cls(tok=torch.zeros(1, **i64), n_gen=torch.zeros(1, **i64),
                   done=torch.zeros(1, **flag), stop=torch.zeros(1, **flag),
                   out_buf=torch.zeros((1, max_new + k + 1), **i64),
                   step=torch.zeros((), **i64), iters=torch.zeros((), **i64),
                   accepted=torch.zeros((), **i64),
                   base=torch.zeros((), **i64), cap=torch.zeros((), **i64),
                   key=torch.zeros(2, **i64),
                   temp=torch.zeros((), dtype=torch.float32, device=device))

    def start(self, live: bool, base: int, sampling: SamplingParams) -> None:
        """Reset for a call: nothing emitted; born done unless ``live``."""
        for t in (self.n_gen, self.step, self.iters, self.accepted):
            t.zero_()
        self.done.fill_(not live)
        self.stop.fill_(not live)
        self.base.fill_(base)
        _start_key(self.key, sampling)
        self.temp.fill_(sampling.temperature)


@dataclasses.dataclass
class _DecodeState:
    """The decode loop's device state for B rows, at fixed addresses (the
    captured steps read and write it): the pending token, tokens emitted
    and done flag per row, the token buffer, the step counter, and the
    per-call inputs the steps read (the slot base, right-aligned rows'
    first slots, the sampling key and temperature)."""

    tok: torch.Tensor       # (B,) int64
    n_gen: torch.Tensor     # (B,) int64
    done: torch.Tensor      # (B,) bool
    out_buf: torch.Tensor   # (B, max_new) int64
    step: torch.Tensor      # () int64, decode steps run
    base: torch.Tensor      # () int64
    kv_start: torch.Tensor  # (B,) int32
    key: torch.Tensor       # (2,) int64: prng_key(seed), a dp rank's
    #                         fold_in(prng_key(seed), rank)
    temp: torch.Tensor      # () float32
    # the decoder's per-call counters over ``step`` and ``done``
    # (``call_counts``; None for a decoder that keeps none)
    counts: object = None

    @classmethod
    def zeros(cls, b: int, max_new: int, device,
              decoder) -> "_DecodeState":
        i64 = dict(dtype=torch.int64, device=device)
        st = cls(tok=torch.zeros(b, **i64), n_gen=torch.zeros(b, **i64),
                 done=torch.zeros(b, dtype=torch.bool, device=device),
                 out_buf=torch.zeros((b, max_new), **i64),
                 step=torch.zeros((), **i64), base=torch.zeros((), **i64),
                 kv_start=torch.zeros(b, dtype=torch.int32, device=device),
                 key=torch.zeros(2, **i64),
                 temp=torch.zeros((), dtype=torch.float32, device=device))
        st.counts = decoder.call_counts(max_new, st.step, st.done)
        return st

    def start(self, live: np.ndarray, base: int, sampling: SamplingParams,
              dp_rank: Optional[int] = None) -> None:
        """Reset for a call: no token emitted, rows not ``live`` done."""
        self.n_gen.zero_()
        self.step.zero_()
        self.done.copy_(torch.from_numpy(~live))
        self.base.fill_(base)
        _start_key(self.key, sampling, dp_rank)
        self.temp.fill_(sampling.temperature)

    def append(self, tok) -> None:
        """JAX's loop body on the new token ``tok`` (B,): write it at
        out_buf[b, n_gen[b]] unless the row is done (so that steps after
        every row is done change neither out_buf nor n_gen), mark rows
        whose token is an EOS done, count the token of every row not
        done."""
        idx = self.n_gen[:, None]
        cur = self.out_buf.gather(1, idx)
        tok = tok.to(torch.int64)
        self.out_buf.scatter_(1, idx, torch.where(self.done[:, None], cur,
                                                  tok[:, None]))
        is_eos = (tok == EOS_TOKEN_IDS[0]) | (tok == EOS_TOKEN_IDS[1])
        self.done.logical_or_(is_eos)
        self.n_gen.add_((~self.done).to(torch.int64))
        self.tok.copy_(tok)


class _DoneFlags:
    """Non-blocking reads of "every row is done": ``post`` enqueues the
    flag's copy to pinned host memory and an event; ``read`` waits for
    that event. Two host slots alternate: a slot is read before it is
    posted again. On the CPU the flag is read at once."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        if self.cuda:
            self.host = torch.zeros(2, dtype=torch.bool, pin_memory=True)
            self.i = 0

    def post(self, done):
        if not self.cuda:
            return bool(done.all())
        slot = self.host[self.i]
        self.i ^= 1
        slot.copy_(done.all(), non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return slot, event

    def read(self, posted) -> bool:
        if not self.cuda:
            return posted
        slot, event = posted
        with span("wait.done_flags"):
            event.synchronize()
        return bool(slot)
