# A copy of qwen3_asr_rs_tpu/config.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Model configuration, loaded from a HuggingFace-style ``config.json``.

Every field carries the same default as the reference implementation
(reference: src/config.rs:52-113) so that partial configs work. The config
tree mirrors the on-disk JSON:

    {"thinker_config": {"audio_config": {...}, "text_config": {...}}}
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Optional, Sequence


@dataclasses.dataclass(frozen=True)
class AudioEncoderConfig:
    """Whisper-style audio encoder config (reference: src/config.rs:26-62)."""

    d_model: int = 896
    encoder_layers: int = 18
    encoder_attention_heads: int = 14
    encoder_ffn_dim: int = 3584
    num_mel_bins: int = 128
    max_source_positions: int = 1500
    n_window: int = 50
    n_window_infer: int = 800
    conv_chunksize: int = 500
    downsample_hidden_size: int = 480
    output_dim: int = 1024

    @property
    def chunk_frames(self) -> int:
        """Mel frames per encoder chunk (n_window * 2)."""
        return self.n_window * 2

    @property
    def chunks_per_window(self) -> int:
        """Chunks grouped into one attention window."""
        return self.n_window_infer // self.chunk_frames

    @property
    def tokens_per_chunk(self) -> int:
        """Output tokens of the conv stem for one full chunk."""
        return feat_extract_output_length(self.chunk_frames)

    @property
    def head_dim(self) -> int:
        return self.d_model // self.encoder_attention_heads


def feat_extract_output_length(input_frames: int) -> int:
    """Token count after the 3x stride-2 conv stem.

    Matches reference src/audio_encoder.rs:263-266: three applications of
    ``(len - 1) // 2 + 1``.
    """
    n = input_frames
    for _ in range(3):
        n = (n - 1) // 2 + 1
    return n


def audio_tokens(audio: AudioEncoderConfig, n_frames: int) -> int:
    """A clip's audio tokens from its true mel frame count
    (src/audio_encoder.rs:269-279): ``tokens_per_chunk`` for each full
    chunk, the conv stem's output of the partial tail (0 for none)."""
    full, tail = divmod(n_frames, audio.chunk_frames)
    return full * audio.tokens_per_chunk + feat_extract_output_length(tail)


@dataclasses.dataclass(frozen=True)
class RopeScaling:
    """MRoPE scaling block (reference: src/config.rs:101-113)."""

    rope_type: str = ""
    mrope_section: tuple = (24, 20, 20)
    interleaved: bool = False
    mrope_interleaved: bool = False


@dataclasses.dataclass(frozen=True)
class TextDecoderConfig:
    """Qwen3 decoder config (reference: src/config.rs:64-99)."""

    vocab_size: int = 151936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    rope_scaling: Optional[RopeScaling] = None
    tie_word_embeddings: bool = True

    # the dense decoder of Qwen3-ASR (``models/text_decoder.py``)
    model_type = "qwen3"

    def mrope_section(self) -> Sequence[int]:
        if self.rope_scaling is not None:
            return tuple(self.rope_scaling.mrope_section)
        return (24, 20, 20)

    def mrope_interleaved(self) -> bool:
        if self.rope_scaling is not None:
            return bool(
                self.rope_scaling.mrope_interleaved or self.rope_scaling.interleaved
            )
        return False


@dataclasses.dataclass(frozen=True)
class DeepseekV3TextConfig:
    """A ``deepseek_v3`` decoder (``models/deepseek_v3_decoder.py``):
    multi-head latent attention and routed experts with shared ones, the
    fields named as in the published ``config.json`` (transformers'
    ``DeepseekV3Config``; Kimi-VL-A3B's language model is one). Its own
    dataclass, so that ``TextDecoderConfig`` stays the JAX package's
    field for field. Layers below ``first_k_dense_replace`` run a dense
    MLP of ``intermediate_size``; the others route each token to
    ``num_experts_per_tok`` of ``n_routed_experts`` experts of
    ``moe_intermediate_size`` beside ``n_shared_experts`` shared ones.
    Positions are 1-D rope over ``qk_rope_head_dim`` (Qwen3-ASR's
    positions: every MRoPE row is the same)."""

    model_type: str = "deepseek_v3"
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    num_key_value_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    scoring_func: str = "sigmoid"
    topk_method: str = "noaux_tc"
    n_group: int = 1
    topk_group: int = 1
    first_k_dense_replace: int = 1
    moe_layer_freq: int = 1
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    hidden_act: str = "silu"
    attention_bias: bool = False
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    rope_scaling: Optional[dict] = None
    rope_interleave: bool = True
    tie_word_embeddings: bool = False

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def latent_dim(self) -> int:
        """Values per position and layer in the latent cache: the normed
        ``c_kv`` and the roped shared key."""
        return self.kv_lora_rank + self.qk_rope_head_dim

    @property
    def n_moe_layers(self) -> int:
        return self.num_hidden_layers - self.first_k_dense_replace

    def check(self) -> "DeepseekV3TextConfig":
        """Raise ValueError for settings the decoder does not compute."""
        bad = {k: getattr(self, k) for k, ok in (
            ("q_lora_rank", None), ("scoring_func", "sigmoid"),
            ("topk_method", "noaux_tc"), ("n_group", 1), ("topk_group", 1),
            ("moe_layer_freq", 1), ("hidden_act", "silu"),
            ("attention_bias", False), ("rope_scaling", None))
            if getattr(self, k) != ok}
        if bad:
            raise ValueError(
                f"deepseek_v3 settings the port does not compute: {bad}")
        return self


# text_config model_type -> its config class; a config that names none is
# Qwen3-ASR's dense decoder, as is "qwen3_asr_text" (the family's
# "<model>_text" naming, as Qwen3-Omni's "qwen3_omni_moe_text")
TEXT_CONFIGS = {"qwen3": TextDecoderConfig,
                "qwen3_asr_text": TextDecoderConfig,
                "deepseek_v3": DeepseekV3TextConfig}


@dataclasses.dataclass(frozen=True)
class ThinkerConfig:
    audio_config: AudioEncoderConfig = dataclasses.field(
        default_factory=AudioEncoderConfig
    )
    text_config: TextDecoderConfig = dataclasses.field(
        default_factory=TextDecoderConfig
    )
    audio_start_token_id: int = 151669
    audio_end_token_id: int = 151670
    audio_token_id: int = 151676


@dataclasses.dataclass(frozen=True)
class AsrConfig:
    thinker_config: ThinkerConfig = dataclasses.field(default_factory=ThinkerConfig)

    @property
    def audio(self) -> AudioEncoderConfig:
        return self.thinker_config.audio_config

    @property
    def text(self) -> TextDecoderConfig:
        return self.thinker_config.text_config

    @classmethod
    def from_file(cls, path: str | Path) -> "AsrConfig":
        with open(path, "r", encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    @classmethod
    def from_dict(cls, d: dict) -> "AsrConfig":
        tc = d.get("thinker_config", {})
        audio = _filtered_dataclass(AudioEncoderConfig, tc.get("audio_config", {}))
        text_raw = dict(tc.get("text_config", {}))
        text = _text_config(text_raw, {k: v for k, v in d.items()
                                       if k not in ("thinker_config",
                                                    "model_type")})
        thinker = _filtered_dataclass(
            ThinkerConfig,
            {k: v for k, v in tc.items() if k not in ("audio_config", "text_config")},
            audio_config=audio,
            text_config=text,
        )
        return cls(thinker_config=thinker)


def _text_config(raw: dict, top: dict):
    """The text config of ``raw`` by its ``model_type`` (none: Qwen3's);
    an unknown one raises ValueError rather than build a decoder that
    ignores what it does not understand. A ``deepseek_v3`` config takes
    the fields ``raw`` does not give from ``top``, the file's top level,
    where the published config's keys stand in a multimodal model's
    flattened form (the benchmark's ``kimi-vl-a3b-asr.json``)."""
    kind = raw.get("model_type", "qwen3")
    if kind not in TEXT_CONFIGS:
        raise ValueError(
            f"text_config model_type {kind!r} is not supported "
            f"(known: {sorted(TEXT_CONFIGS)})")
    if TEXT_CONFIGS[kind] is DeepseekV3TextConfig:
        return _filtered_dataclass(DeepseekV3TextConfig,
                                   {**top, **raw}).check()
    rope_scaling = raw.pop("rope_scaling", None)
    if rope_scaling is not None:
        rs = dict(rope_scaling)
        if "mrope_section" in rs:
            rs["mrope_section"] = tuple(rs["mrope_section"])
        rope_scaling = _filtered_dataclass(RopeScaling, rs)
    return _filtered_dataclass(TextDecoderConfig, raw,
                               rope_scaling=rope_scaling)


def _filtered_dataclass(cls, raw: dict, **overrides: Any):
    """Build a dataclass from a dict, ignoring unknown keys (serde-default style)."""
    names = {f.name for f in dataclasses.fields(cls)}
    kwargs = {k: v for k, v in raw.items() if k in names}
    kwargs.update(overrides)
    return cls(**kwargs)


def synthetic_17b_config() -> AsrConfig:
    """Full-scale Qwen3-ASR-1.7B-shaped config for on-chip benchmarking.

    Text-tower shapes follow Qwen3-1.7B (hidden 2048, intermediate 6144,
    28 layers, 16Q/8KV heads, head_dim 128, untied lm_head — the 1.7B
    family unties it, matching the reference's lm_head fallback logic,
    src/text_decoder.rs:71-79). The audio tower keeps the 0.6B defaults
    with output_dim widened to the text hidden size; real deployments
    read the exact shapes from the checkpoint's config.json, which the
    loader parses at runtime (reference ci.yml:138-164 runs this family).
    """
    return AsrConfig(
        ThinkerConfig(
            audio_config=AudioEncoderConfig(output_dim=2048),
            text_config=TextDecoderConfig(
                hidden_size=2048,
                intermediate_size=6144,
                tie_word_embeddings=False,
            ),
        )
    )


def tiny_test_config() -> AsrConfig:
    """A miniature config with the real architecture shape, for unit tests."""
    return AsrConfig(
        ThinkerConfig(
            audio_config=AudioEncoderConfig(
                d_model=64,
                encoder_layers=2,
                encoder_attention_heads=4,
                encoder_ffn_dim=128,
                downsample_hidden_size=32,
                # must equal text hidden_size (audio embeds are injected
                # directly into the decoder's embedding stream)
                output_dim=64,
            ),
            text_config=TextDecoderConfig(
                vocab_size=1024,
                hidden_size=64,
                intermediate_size=128,
                num_hidden_layers=2,
                num_attention_heads=4,
                num_key_value_heads=2,
                head_dim=16,
            ),
        )
    )
