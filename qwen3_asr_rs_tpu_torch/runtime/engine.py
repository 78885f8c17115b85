"""AsrEngine — end-to-end greedy transcription in PyTorch.

Port of the greedy paths of ``qwen3_asr_rs_tpu/runtime/engine.py``:
log-mel -> audio encoder -> prompt embedding with the audio embeddings
injected at ``AUDIO_OFFSET`` -> prefill -> greedy decode until an EOS
token or ``max_new_tokens``, for one utterance (left-aligned prompt) or
a batch (``transcribe_batch``: padded to a power of two with born-done
rows, one shared chunk bucket, right-aligned prompts, per-row EOS).
Audio lengths round up to the same chunk buckets and prompt buckets as
the JAX engine.

Differences from the JAX engine, none of which changes the tokens: the
decode loop is a Python loop with one host read of the B tokens per
step (CUDA graphs are later work); mel and the encoder loop over the
batch's clips instead of ``vmap``; and the KV slab is allocated once at
its final length instead of in growing segments, without the JAX
engine's 8/128-slot rounding (masks make the output independent of the
slab length). Weight quantization follows the JAX engine's ``quantize=``
modes 'int8', 'int4', 'int4g' (group-wise int4, ``ASR_INT4_GROUP``) and
'lm8' (with ``ASR_MERGE_QKV`` and ``ASR_LM_BITS``), the KV slab its
``kv_dtype=`` 'bf16' (the compute dtype) and 'int8' (``ASR_KV``), and
``ASR_FOLD_LM=1`` folds the lm_head and argmax into the decode kernel,
whose steps then return token ids (default off, as in JAX). Sampling,
speculative decoding and long-form audio (beyond the largest bucket) are
not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from ..audio.load import load_audio
from ..config import AsrConfig, feat_extract_output_length
from ..features.mel import (
    create_mel_filterbank,
    log_mel_from_padded,
    num_mel_frames,
    pad_waveform,
)
from ..models.audio_encoder import AudioEncoder
from ..models.text_decoder import KVCache, TextDecoder
from ..ops.kernels.decode_layer import int4g_group_supported
from ..tokenizer import ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID, AsrTokenizer
from ..weights.convert import to_torch
from ..weights.loader import load_model_params
from ..weights.quantize import quantize_decoder_params, quantize_lm_head_only
from .prompt import AUDIO_OFFSET, build_prompt, parse_asr_output

logger = logging.getLogger(__name__)

# Audio-length buckets in encoder chunks (1 chunk == 1 s of audio).
DEFAULT_CHUNK_BUCKETS = (1, 2, 4, 8, 15, 30, 60, 120, 240, 360)

# Prompt-length allowance beyond the audio tokens: header(9) + tail(6)
# + forced-language tokens (a handful). Rounded up for alignment.
PROMPT_SLACK = 32

EOS_TOKEN_IDS = (ENDOFTEXT_TOKEN_ID, IM_END_TOKEN_ID)


@dataclasses.dataclass
class TranscribeResult:
    text: str
    language: str
    raw_output: str
    # time-stamped spans (the JAX engine's runtime/longform.Segment);
    # not produced by this port yet
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
        decode step)."""
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
        if params is None:
            logger.info("Loading weights from %s", model_dir)
            params = load_model_params(model_dir, config, dtype, self.device)
        else:
            params = to_torch(params, dtype, self.device)
        self.enc_params, self.dec_params = params
        del params  # so the float linears are freed once quantized
        self.quantize = quantize
        gsize = int(os.environ.get("ASR_INT4_GROUP", "128"))
        t = config.text
        ks = (t.hidden_size, t.num_attention_heads * t.head_dim,
              t.intermediate_size)
        if (quantize == "int4g" and self.device.type == "cuda"
                and not int4g_group_supported(gsize, ks)):
            raise ValueError(
                f"ASR_INT4_GROUP={gsize}: the CUDA decode kernel takes int4 "
                "group sizes 32, 64 and multiples of 128 that divide every "
                f"projection's input width {ks}")
        self.dec_params = self._quantize_params(self.dec_params, quantize,
                                                gsize)
        if kv_dtype is None:
            kv_dtype = os.environ.get("ASR_KV")
        if kv_dtype not in (None, "bf16", "int8"):
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        self.kv_quant = kv_dtype == "int8"
        if tokenizer is None:
            tokenizer = AsrTokenizer.from_dir(model_dir)
        self.tokenizer = tokenizer

        self.mel_filters = torch.from_numpy(
            create_mel_filterbank(config.audio.num_mel_bins)
        ).to(self.device)
        self.encoder = AudioEncoder(config.audio, device=self.device)
        max_pos = 16
        for c in self.chunk_buckets:
            max_pos = max(max_pos, self._prompt_bucket(c) + max_new_tokens + 8)
        self.decoder = TextDecoder(config.text, max_position=max_pos,
                                   device=self.device)
        # step count and stage times of the last generate() call
        self.last_stats: dict = {}

    @staticmethod
    def _quantize_params(dec, quantize: Optional[str], gsize: int = 128):
        """The decoder tree under a weight-quantization mode (the JAX
        engine's ``_quantize_params`` for one device); ``gsize``: int4g's
        rows per scale group."""
        if quantize is None:
            return dec
        if quantize in ("int8", "int4"):
            logger.info("Quantizing decoder weights to %s", quantize)
            merge = os.environ.get("ASR_MERGE_QKV", "1") != "0"
            return quantize_decoder_params(
                dec, bits=4 if quantize == "int4" else 8, merge=merge)
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

    def _pick_bucket(self, n_frames: int) -> int:
        cf = self.config.audio.chunk_frames
        chunks_needed = -(-n_frames // cf)
        for c in self.chunk_buckets:
            if c >= chunks_needed:
                return c
        raise ValueError(
            f"audio needs {chunks_needed} chunks, exceeding the largest "
            f"bucket {self.chunk_buckets[-1]}; long-form audio is not "
            "ported to the PyTorch package yet"
        )

    @property
    def max_bucket_seconds(self) -> float:
        cf = self.config.audio.chunk_frames
        return self.chunk_buckets[-1] * cf * 160 / 16000

    def _slab_len(self, p_bucket: int) -> int:
        return -(-(p_bucket + self.max_new_tokens + 1) // 8) * 8

    def _new_cache(self, batch: int, p_bucket: int) -> KVCache:
        return KVCache.zeros(self.config.text, batch, self._slab_len(p_bucket),
                             dtype=self.dtype, device=self.device,
                             quantized=self.kv_quant)

    @torch.inference_mode()
    def _embed_prompts(self, samples_list: Sequence[np.ndarray],
                       languages: Sequence[Optional[str]], aligned: bool):
        """Mel, encoder and prompt embedding with audio injection for
        utterances that share one chunk bucket (the largest any needs).
        Prompts sit at slots [0, len) or, ``aligned``, end at the prompt
        bucket P; each row's audio goes to its prompt start +
        ``AUDIO_OFFSET``. Returns (hidden (B, P, H), true prompt lengths)."""
        cfg = self.config
        cf = cfg.audio.chunk_frames
        tpc = cfg.audio.tokens_per_chunk
        bucket_chunks = max(self._pick_bucket(num_mel_frames(len(s)))
                            for s in samples_list)
        p_bucket = self._prompt_bucket(bucket_chunks)
        ids = torch.zeros((len(samples_list), p_bucket), dtype=torch.long)
        audio, true_lens = [], []
        for i, (samples, language) in enumerate(zip(samples_list, languages)):
            wave, n_true = pad_waveform(samples, bucket_frames=bucket_chunks * cf)
            tail = n_true % cf
            n_audio = (n_true // cf) * tpc + (
                feat_extract_output_length(tail) if tail else 0
            )
            prompt = build_prompt(n_audio, language, self.tokenizer)
            if len(prompt) > p_bucket:
                raise ValueError("prompt exceeds bucket; language string too long")
            start = p_bucket - len(prompt) if aligned else 0
            ids[i, start: start + len(prompt)] = torch.tensor(prompt)
            true_lens.append(len(prompt))
            mel = log_mel_from_padded(torch.from_numpy(wave).to(self.device),
                                      n_true, self.mel_filters)
            embeds, _ = self.encoder(self.enc_params, mel, n_true)
            audio.append((start + AUDIO_OFFSET, embeds[:n_audio]))
        hidden = self.decoder.embed(self.dec_params, ids.to(self.device))
        for i, (at, embeds) in enumerate(audio):
            hidden[i, at: at + len(embeds)] = embeds.to(hidden.dtype)
        return hidden, true_lens

    @torch.inference_mode()
    def prefill(self, samples: np.ndarray, language: Optional[str] = None):
        """Mel, encoder, prompt injection and prefill for one utterance.
        Returns (logits (1, V) at the last prompt token, KV cache,
        true prompt length)."""
        hidden, (true_len,) = self._embed_prompts([samples], [language],
                                                  aligned=False)
        p_bucket = hidden.shape[1]
        cache = self._new_cache(1, p_bucket)
        logits, cache = self.decoder.prefill(
            self.dec_params, hidden, torch.arange(p_bucket, device=self.device),
            cache, true_len,
        )
        return logits, cache, true_len

    @torch.inference_mode()
    def generate(self, samples: np.ndarray,
                 language: Optional[str] = None) -> list[int]:
        """Greedy token ids for one utterance (EOS excluded).

        Fills ``last_stats``: decode steps run, and host-clock seconds of
        the part up to the first token (mel, encoder, prefill; it ends in
        the first token's host read) and of the decode loop.
        """
        t0 = time.perf_counter()
        logits, cache, true_len = self.prefill(samples, language)
        tok = torch.argmax(logits, dim=-1)
        return self._decode_loop(
            tok, np.ones(1, bool), t0,
            lambda tok, step: self.decoder.decode_step_token(
                self.dec_params, tok, true_len + step, cache)[0],
        )[0]

    @torch.inference_mode()
    def prefill_batch(self, samples_list: Sequence[np.ndarray],
                      languages: Sequence[Optional[str]]):
        """Mel, encoder, prompt injection and right-aligned prefill for B
        utterances: row b's prompt spans slots [kv_start_b, P). Returns
        (logits (B, V) at slot P - 1, KV cache, kv_start (B,) int32, P)."""
        hidden, true_lens = self._embed_prompts(samples_list, languages,
                                                aligned=True)
        b, p_bucket = hidden.shape[:2]
        kv_start = torch.tensor([p_bucket - n for n in true_lens],
                                dtype=torch.int32, device=self.device)
        cache = self._new_cache(b, p_bucket)
        logits, cache = self.decoder.prefill_aligned(self.dec_params, hidden,
                                                     kv_start, cache)
        return logits, cache, kv_start, p_bucket

    @torch.inference_mode()
    def generate_batch(self, samples_list: Sequence[np.ndarray],
                       languages: Sequence[Optional[str]],
                       live: np.ndarray) -> list[list[int]]:
        """Greedy token ids (EOS excluded) for B > 1 utterances in one
        right-aligned batch (``prefill_batch``); decode step i writes slot
        P + i for every row. Rows with ``live`` False are born done and
        emit no token. Fills ``last_stats`` as ``generate`` does."""
        t0 = time.perf_counter()
        logits, cache, kv_start, p_bucket = self.prefill_batch(samples_list,
                                                               languages)
        tok = torch.argmax(logits, dim=-1)
        return self._decode_loop(
            tok, np.asarray(live, bool), t0,
            lambda tok, step: self.decoder.decode_step_aligned_token(
                self.dec_params, tok, p_bucket + step, kv_start, cache)[0],
        )

    def _decode_loop(self, tok, live: np.ndarray, t0: float, step_fn):
        """Greedy decode of B rows from the prefill's tokens ``tok`` (B,):
        each iteration reads the B tokens with one host read, appends each
        live row's token until its EOS, and stops when every row is done
        or a row holds ``max_new_tokens``; ``step_fn(tok, i)`` runs decode
        step i. Returns the tokens of every row (none for rows not live)."""
        done = ~live
        generated: list[list[int]] = [[] for _ in range(len(live))]
        steps = 0
        t_first = None
        while steps < self.max_new_tokens:
            toks = tok.tolist()  # the one host sync per step
            if t_first is None:
                t_first = time.perf_counter()
            for i, t in enumerate(toks):
                if not done[i]:
                    if t in EOS_TOKEN_IDS:
                        done[i] = True
                    else:
                        generated[i].append(t)
            if done.all() or steps + 1 == self.max_new_tokens:
                break
            tok = step_fn(tok, steps)
            steps += 1
        t_end = time.perf_counter()
        t_first = t_end if t_first is None else t_first
        self.last_stats = {
            "decode_steps": steps,
            "prefill_seconds": t_first - t0,
            "decode_seconds": t_end - t_first,
            "n_gen": [len(g) for g in generated],
        }
        return generated

    def _result(self, generated: list[int],
                language: Optional[str]) -> TranscribeResult:
        raw = self.tokenizer.decode(generated)
        lang, text = parse_asr_output(raw, language is not None)
        return TranscribeResult(text=text, language=lang, raw_output=raw)

    def transcribe_samples(self, samples: np.ndarray,
                           language: Optional[str] = None) -> TranscribeResult:
        """Transcribe mono 16 kHz f32 samples."""
        generated = self.generate(samples, language)
        logger.info("Generated %d tokens", len(generated))
        return self._result(generated, language)

    def transcribe_batch(self, samples_list: list,
                         languages: Optional[list] = None) -> list:
        """Transcribe a batch of utterances in one prefill and one decode
        loop with per-example EOS (the JAX engine's ``transcribe_batch``,
        greedy): the decode step streams the weights once for all rows.

        The batch pads to the next power of two by repeating the last
        utterance; pad rows are born done and emit nothing. A single
        utterance takes the left-aligned B = 1 path. ``last_stats["n_gen"]``
        holds the token count of every row, pad rows included.
        """
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
        if n_real == 1:
            return [self.transcribe_samples(samples_list[0], languages[0])]
        b = 1 << (n_real - 1).bit_length()
        samples_list = list(samples_list) + [samples_list[-1]] * (b - n_real)
        languages = list(languages) + [languages[-1]] * (b - n_real)
        live = np.arange(b) < n_real
        generated = self.generate_batch(samples_list, languages, live)
        logger.info("Generated %s tokens", self.last_stats["n_gen"][:n_real])
        return [self._result(g, lang)
                for g, lang in zip(generated[:n_real], languages)]

    def transcribe(self, audio_path: str | Path,
                   language: Optional[str] = None) -> TranscribeResult:
        """Transcribe an audio file that fits the largest bucket."""
        samples = load_audio(audio_path, 16000)
        if len(samples) > int(self.max_bucket_seconds * 16000):
            raise ValueError(
                f"audio of {len(samples) / 16000:.1f}s exceeds the largest "
                f"bucket ({self.max_bucket_seconds:.0f}s); long-form audio "
                "is not ported to the PyTorch package yet"
            )
        return self.transcribe_samples(samples, language)
