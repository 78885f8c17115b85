# A copy of qwen3_asr_rs_tpu/audio/__init__.py: the port keeps its own, so that it imports nothing of the JAX package.
from .load import load_audio
from .resample import resample_sinc

__all__ = ["load_audio", "resample_sinc"]
