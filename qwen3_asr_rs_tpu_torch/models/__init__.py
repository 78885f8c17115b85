"""Audio encoder and text decoder; their synthetic initialisers live in
``weights/convert.py`` and are re-exported here, as the JAX package
exports its own."""

from ..weights.convert import init_decoder_params, init_encoder_params
from .audio_encoder import AudioEncoder
from .text_decoder import TextDecoder

__all__ = [
    "TextDecoder",
    "init_decoder_params",
    "AudioEncoder",
    "init_encoder_params",
]
