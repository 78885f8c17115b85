"""Each architecture's text decoder (``DECODERS``, by text config class).
A decoder class states in ``modes`` the modes of the port it runs; the
code of a mode calls ``require`` first. Every decoder runs the offline
path (``AsrEngine.transcribe_batch``)."""

from __future__ import annotations

from ..config import DeepseekV3TextConfig, TextDecoderConfig
from ..errors import ArchitectureNotSupported
from .deepseek_v3_decoder import DeepseekV3Decoder
from .text_decoder import TextDecoder

DECODERS = {
    TextDecoderConfig: TextDecoder,
    DeepseekV3TextConfig: DeepseekV3Decoder,
}

# the dense decoder runs every mode
MODES = TextDecoder.modes


def decoder_class(text_config) -> type:
    """The decoder class of ``text_config``'s architecture."""
    return DECODERS[type(text_config)]


def require(text_config, mode: str, name: str | None = None) -> None:
    """Raise ``ArchitectureNotSupported`` unless ``text_config``'s decoder
    runs ``mode`` (one of ``MODES``); ``name``: the mode as the message
    gives it (default ``mode``)."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    if mode not in decoder_class(text_config).modes:
        raise ArchitectureNotSupported(
            f"{name or mode} does not run the {text_config.model_type} "
            "decoder; its offline path is AsrEngine.transcribe_batch")
