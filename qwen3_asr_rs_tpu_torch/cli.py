"""Command-line interface of the PyTorch port.

Contract-compatible with ``qwen3_asr_rs_tpu/cli.py`` for the main path:

    python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file> [language]
    python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file>... [--language LANG]

prints ``Language: <lang>`` and ``Text: <text>`` (preceded by ``File:``
per file when several are given), or a one-line ``Error: ...`` on
stderr with exit code 1. Several files are transcribed as one batch
(``AsrEngine.transcribe_batch``: one prefill and one decode loop), as
the JAX CLI does; its sampling, timestamp and speculative options are
rejected until those paths are ported.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path

USAGE = """\
Qwen3 ASR (PyTorch/CUDA port) - Automatic Speech Recognition

Usage: python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file> [language]
       python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file>... [--language LANG]

Arguments:
  model_path   Path to the Qwen3-ASR model directory
  audio_file   Path to the input audio file (WAV and, via the native
               libav decoder or an ffmpeg binary, any other format)
  language     Optional: force language (e.g., chinese, english, japanese)

Environment variables:
  ASR_LOG / RUST_LOG   Set logging level (e.g., info, debug)
  ASR_MAX_NEW_TOKENS   Cap on generated tokens (default 4096)
  ASR_DTYPE            Compute dtype: bfloat16 (default) or float32
  ASR_DEVICE           Torch device (default cuda)
  ASR_QUANT            Weight quantization: int8 | int4 | int4g | lm8
                       (default none; int4g: group-wise int4 scales)
  ASR_INT4_GROUP       Rows per int4g scale group (default 128)
  ASR_LM_BITS          lm_head width under int8/int4/int4g: 8 | 4 (default:
                       the layers' width; int4g: 8)
  ASR_MERGE_QKV        0 keeps q/k/v and gate/up unmerged when quantizing
  ASR_KV               KV slab: bf16 (default: the compute dtype) | int8
  ASR_FOLD_LM          1 folds the final norm, lm_head and argmax into the
                       decode kernel (not with a 4-bit lm_head)
"""


def setup_logging():
    level_name = (
        os.environ.get("ASR_LOG") or os.environ.get("RUST_LOG") or "info"
    )
    level = getattr(logging, level_name.split(",")[0].upper(), logging.INFO)
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
        stream=sys.stderr,
    )


def main(argv=None) -> int:
    setup_logging()
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) < 2:
        print(USAGE, file=sys.stderr)
        return 1

    model_path = argv[0]
    language = None
    rest = []
    it = iter(argv[1:])
    for arg in it:
        if arg in ("--language", "-l"):
            language = next(it, None)
            if language is None:
                print("Error: --language needs a value", file=sys.stderr)
                return 1
        elif arg.startswith("--language="):
            language = arg.split("=", 1)[1]
        elif arg.startswith("--"):
            print(
                f"Error: option {arg.split('=', 1)[0]} is not supported by "
                "the PyTorch port yet",
                file=sys.stderr,
            )
            return 1
        else:
            rest.append(arg)
    if language is None and len(rest) == 2:
        if not Path(rest[1]).exists():
            language = rest.pop()
        elif "." not in Path(rest[1]).name:
            logging.getLogger("asr").warning(
                "treating %r as an audio file because it exists; pass "
                "--language %s if you meant to force a language",
                rest[1], rest[1],
            )
    audio_files = rest
    for f in audio_files:
        if not Path(f).exists():
            print(f"Error: Audio file not found: {f}", file=sys.stderr)
            return 1
    if not Path(model_path).exists():
        print(f"Error: Model directory not found: {model_path}",
              file=sys.stderr)
        return 1
    if not audio_files:
        print("Error: no audio file given", file=sys.stderr)
        return 1

    import torch

    from .errors import AsrError
    from .runtime.engine import AsrEngine, load_audio

    device = os.environ.get("ASR_DEVICE", "cuda")
    if device.startswith("cuda") and not torch.cuda.is_available():
        print("Error: no CUDA device (set ASR_DEVICE=cpu to run on the CPU)",
              file=sys.stderr)
        return 1
    dtype = (
        torch.float32
        if os.environ.get("ASR_DTYPE", "").lower() in ("float32", "f32")
        else torch.bfloat16
    )
    max_new = int(os.environ.get("ASR_MAX_NEW_TOKENS", "4096"))
    quantize = os.environ.get("ASR_QUANT") or None
    logger = logging.getLogger("asr")
    try:
        engine = AsrEngine(model_path, dtype=dtype, max_new_tokens=max_new,
                           device=device, quantize=quantize)
        if len(audio_files) == 1:
            logger.info("Transcribing: %s", audio_files[0])
            result = engine.transcribe(audio_files[0], language)
            print(f"Language: {result.language}")
            print(f"Text: {result.text}")
            return 0
        logger.info("Transcribing %d files as one batch", len(audio_files))
        samples = [load_audio(f, 16000) for f in audio_files]
        results = engine.transcribe_batch(samples, [language] * len(samples))
        for f, result in zip(audio_files, results):
            print(f"File: {f}")
            print(f"Language: {result.language}")
            print(f"Text: {result.text}")
        return 0
    except (AsrError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
