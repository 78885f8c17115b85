"""qwen3_asr_rs_tpu_torch — the PyTorch/CUDA port of qwen3_asr_rs_tpu.

The same Qwen3-ASR pipeline (log-mel -> windowed audio encoder -> prompt
injection -> prefill -> greedy decode) in PyTorch, with the JAX
package's Pallas kernels replaced by hand-written CUDA C++ kernels for
Hopper (``sm_90a``, sources in ``csrc/``). The JAX package stays the
reference: every module here mirrors the JAX module of the same name and
is held against it by the ``tests/test_torch_*.py`` suite.

This package imports ``torch`` and never ``jax``, and nothing of the JAX
package: it keeps its own copies of the JAX-free modules ``config``,
``errors``, ``tokenizer`` and ``audio``.
"""

__version__ = "0.1.0"

from .config import (
    AsrConfig,
    AudioEncoderConfig,
    TextDecoderConfig,
    ThinkerConfig,
)

__all__ = [
    "AsrConfig",
    "AudioEncoderConfig",
    "TextDecoderConfig",
    "ThinkerConfig",
    "__version__",
]
