# A copy of qwen3_asr_rs_tpu/errors.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Typed error hierarchy (analog of the reference's error enum).

The reference defines an `AsrError` enum with Audio/Model/Config/Tokenizer/
Weights/Io variants (src/error.rs:3-29). Python surfaces the same taxonomy
as an exception hierarchy so callers can catch categories precisely.
"""

from __future__ import annotations


class AsrError(Exception):
    """Base class for all framework errors."""


class AudioError(AsrError):
    """Audio decoding / resampling failed."""


class ModelError(AsrError):
    """Model construction or forward failure."""


class ConfigError(AsrError):
    """config.json missing or malformed."""


class TokenizerError(AsrError):
    """tokenizer.json missing or invalid."""


class WeightsError(AsrError):
    """Checkpoint missing tensors or unreadable."""


class ArchitectureNotSupported(NotImplementedError):
    """A mode of the port that does not run a decoder architecture
    (``models/decoders.py::require``)."""
