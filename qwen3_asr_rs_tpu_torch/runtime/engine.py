"""AsrEngine — end-to-end single-utterance transcription in PyTorch.

Port of the B = 1 greedy path of ``qwen3_asr_rs_tpu/runtime/engine.py``:
log-mel -> audio encoder -> prompt embedding with the audio embeddings
injected at ``AUDIO_OFFSET`` -> prefill -> greedy decode until an EOS
token or ``max_new_tokens``. Audio lengths round up to the same chunk
buckets and prompt buckets as the JAX engine.

Differences from the JAX engine, none of which changes the tokens: the
decode loop is a Python loop with one host read of the token per step
(CUDA graphs are later work), and the KV slab is allocated once at its
final length instead of in growing segments (masks make the output
independent of the slab length). Weight quantization follows the JAX
engine's ``quantize=`` modes 'int8', 'int4' and 'lm8' (with
``ASR_MERGE_QKV`` and ``ASR_LM_BITS``); 'int4g', batches of more than one
utterance, sampling, int8 KV, speculative decoding and long-form audio
(beyond the largest bucket) are not ported yet and raise.
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

from qwen3_asr_rs_tpu.audio.load import load_audio
from qwen3_asr_rs_tpu.config import AsrConfig, feat_extract_output_length
from qwen3_asr_rs_tpu.tokenizer import (
    ENDOFTEXT_TOKEN_ID,
    IM_END_TOKEN_ID,
    AsrTokenizer,
)

from ..features.mel import (
    create_mel_filterbank,
    log_mel_from_padded,
    num_mel_frames,
    pad_waveform,
)
from ..models.audio_encoder import AudioEncoder
from ..models.text_decoder import KVCache, TextDecoder
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
    ):
        """``params``: optional (encoder, decoder) trees (torch tensors or
        numpy arrays in the JAX layouts), cast to ``dtype`` on ``device``.
        ``device`` is explicit: there is no CPU fallback for "cuda".
        ``quantize``: None, 'int8', 'int4' or 'lm8' (int8 lm_head only),
        applied to the decoder weights after the cast to ``dtype``, as the
        JAX engine does."""
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
        self.dec_params = self._quantize_params(self.dec_params, quantize)
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
    def _quantize_params(dec, quantize: Optional[str]):
        """The decoder tree under a weight-quantization mode (the JAX
        engine's ``_quantize_params`` for one device)."""
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
            raise NotImplementedError(
                "quantize='int4g' (group-wise int4 scales) is not ported to "
                "the PyTorch package yet (ROADMAP §1 item 11)"
            )
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

    @torch.inference_mode()
    def prefill(self, samples: np.ndarray, language: Optional[str] = None):
        """Mel, encoder, prompt injection and prefill for one utterance.
        Returns (logits (1, V) at the last prompt token, KV cache,
        true prompt length)."""
        cfg = self.config
        cf = cfg.audio.chunk_frames
        tpc = cfg.audio.tokens_per_chunk
        bucket_chunks = self._pick_bucket(num_mel_frames(len(samples)))
        p_bucket = self._prompt_bucket(bucket_chunks)
        wave, n_true = pad_waveform(samples, bucket_frames=bucket_chunks * cf)
        tail = n_true % cf
        n_audio = (n_true // cf) * tpc + (
            feat_extract_output_length(tail) if tail else 0
        )
        prompt = build_prompt(n_audio, language, self.tokenizer)
        if len(prompt) > p_bucket:
            raise ValueError("prompt exceeds bucket; language string too long")
        ids = torch.zeros((1, p_bucket), dtype=torch.long)
        ids[0, : len(prompt)] = torch.tensor(prompt)
        ids = ids.to(self.device)
        true_len = len(prompt)

        wave_t = torch.from_numpy(wave).to(self.device)
        mel = log_mel_from_padded(wave_t, n_true, self.mel_filters)
        audio_embeds, _ = self.encoder(self.enc_params, mel, n_true)

        dec = self.decoder
        hidden = dec.embed(self.dec_params, ids)  # (1, P, H)
        hidden[0, AUDIO_OFFSET: AUDIO_OFFSET + n_audio] = (
            audio_embeds[:n_audio].to(hidden.dtype)
        )
        cache = KVCache.zeros(cfg.text, 1, self._slab_len(p_bucket),
                              dtype=self.dtype, device=self.device)
        logits, cache = dec.prefill(
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
        generated: list[int] = []
        steps = 0
        t_first = None
        while len(generated) < self.max_new_tokens:
            t = int(tok[0])  # the one host sync per step
            if t_first is None:
                t_first = time.perf_counter()
            if t in EOS_TOKEN_IDS:
                break
            generated.append(t)
            if len(generated) == self.max_new_tokens:
                break
            tok, cache = self.decoder.decode_step_token(
                self.dec_params, tok, true_len + steps, cache
            )
            steps += 1
        t_end = time.perf_counter()
        t_first = t_end if t_first is None else t_first
        self.last_stats = {
            "decode_steps": steps,
            "prefill_seconds": t_first - t0,
            "decode_seconds": t_end - t_first,
        }
        return generated

    def transcribe_samples(self, samples: np.ndarray,
                           language: Optional[str] = None) -> TranscribeResult:
        """Transcribe mono 16 kHz f32 samples."""
        generated = self.generate(samples, language)
        raw = self.tokenizer.decode(generated)
        lang, text = parse_asr_output(raw, language is not None)
        logger.info("Generated %d tokens", len(generated))
        return TranscribeResult(text=text, language=lang, raw_output=raw)

    def transcribe_batch(self, samples_list: list,
                         languages: Optional[list] = None) -> list:
        """B = 1 only: batched decode (right-aligned prompts) is not ported."""
        if len(samples_list) == 0:
            return []
        if len(samples_list) > 1:
            raise NotImplementedError(
                "batched transcription is not ported to the PyTorch package "
                "yet; call transcribe_samples per utterance"
            )
        language = languages[0] if languages else None
        return [self.transcribe_samples(samples_list[0], language)]

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
