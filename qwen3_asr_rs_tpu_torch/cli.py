"""Command-line interface of the PyTorch port.

Contract-compatible with ``qwen3_asr_rs_tpu/cli.py`` for the main path:

    python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file> [language]
    python -m qwen3_asr_rs_tpu_torch <model_path> <audio_file>... [--language LANG]

prints ``Language: <lang>`` and ``Text: <text>`` (preceded by ``File:``
per file when several are given), or a one-line ``Error: ...`` on
stderr with exit code 1. Several files are transcribed as one batch
(``AsrEngine.transcribe_batch``: one prefill and one decode loop), as
the JAX CLI does. ``--temperature``/``--top-k``/``--top-p``/``--seed``
sample, ``--timestamps`` prints the segments with their words,
``--draft``/``--draft-model``/``--draft-k`` decode speculatively, and
``ASR_METRICS=<path>`` dumps the stage timers, as in the JAX CLI
(with ``ASR_TRACE=1`` the engine's spans too).
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
  language     Optional: force language (e.g., chinese, english, japanese).
               With a single audio file the third positional argument is
               the language; with several audio files (one batched
               dispatch) use --language.

Options:
  --temperature T   Stochastic decode (default 0 = greedy argmax). Not
                    available for audio longer than the largest bucket
                    (long-form stitching needs deterministic transcripts).
  --top-k K         With --temperature: sample among the K most likely
                    tokens only (0 = disabled).
  --top-p P         With --temperature: nucleus sampling mass (1.0 =
                    disabled).
  --seed N          Seed of the draws for --temperature (default 0).
  --timestamps      After the Text: line, print one `[start - end] text`
                    line per time-stamped segment (long-form audio gets
                    one per stitched chunk, short audio a single span),
                    each followed by indented per-word `[start - end]`
                    lines (length-proportional within the segment).
  --draft MODE      Speculative decoding: draft with a quantized copy of
                    the checkpoint (int4 | int4g | int8 | lm8 | bf16)
                    and verify with the full model: output equal to
                    plain greedy decoding, only faster when the draft
                    agrees often. With --temperature, speculative
                    sampling keeps the target's sampling distribution.
                    Single-file only.
  --draft-model DIR Cross-model speculative decoding: draft with a
                    smaller checkpoint (e.g. 0.6B drafting for a 1.7B
                    model). Combine with --draft to also quantize the
                    draft (e.g. --draft-model 0.6B --draft int4).
  --draft-k N       Draft tokens per verify call (default 4).

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
  ASR_DECODE_SEGMENT   Tokens of the first KV slab segment (default 256;
                       the slab grows 4x per stage)
  ASR_METRICS          Write the stage timers as JSON to this path
  ASR_TRACE            1 records the engine's spans (prefill parts, host
                       waits); with ASR_METRICS they are written beside
                       the timers
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
    sample_opts = {"temperature": 0.0, "top-k": 0, "top-p": 1.0, "seed": 0}
    timestamps = False
    draft = draft_model = None
    draft_k = 4
    rest = []
    it = iter(argv[1:])
    for arg in it:
        if arg == "--timestamps":
            timestamps = True
        elif arg in ("--draft", "--draft-model", "--draft-k") or (
                arg.startswith(("--draft=", "--draft-model=", "--draft-k="))):
            name, eq, val = arg.partition("=")
            if not eq:
                val = next(it, None)
            if name == "--draft-k":
                try:
                    draft_k = int(val)
                except (TypeError, ValueError):
                    print(f"Error: bad --draft-k value {val!r}",
                          file=sys.stderr)
                    return 1
            elif val is None:
                print(f"Error: {name} needs a value", file=sys.stderr)
                return 1
            elif name == "--draft":
                draft = val
            else:
                draft_model = val
        elif arg in ("--language", "-l"):
            language = next(it, None)
            if language is None:
                print("Error: --language needs a value", file=sys.stderr)
                return 1
        elif arg.startswith("--language="):
            language = arg.split("=", 1)[1]
        elif arg.startswith("--") and arg.lstrip("-").split("=")[0] in (
            sample_opts
        ):
            name, eq, val = arg.lstrip("-").partition("=")
            if not eq:
                val = next(it, None)
            if val is None:
                print(f"Error: --{name} needs a value", file=sys.stderr)
                return 1
            try:
                cast = int if name in ("top-k", "seed") else float
                sample_opts[name] = cast(val)
            except ValueError:
                print(f"Error: bad --{name} value {val!r}", file=sys.stderr)
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
    if draft is not None and draft not in (
            "int4", "int4g", "int8", "lm8", "bf16"):
        print(f"Error: unknown --draft mode {draft!r} "
              "(expected int4 | int4g | int8 | lm8 | bf16)", file=sys.stderr)
        return 1
    if draft_model is not None and not Path(draft_model).exists():
        print(f"Error: draft model directory not found: {draft_model}",
              file=sys.stderr)
        return 1
    if (draft is not None or draft_model is not None) and len(audio_files) > 1:
        logging.getLogger("asr").warning(
            "--draft/--draft-model apply to single-file decoding only; "
            "batched requests use the plain decode loop")

    import torch

    from .errors import AsrError
    from .runtime.engine import AsrEngine, load_audio
    from .runtime.longform import Segment, attach_words
    from .runtime.sampling import SamplingParams
    from .utils.tracing import dump_metrics

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

    def print_segments(segments):
        for s in segments or []:
            print(f"[{s.start:.2f} - {s.end:.2f}] {s.text.strip()}")
            for w in s.words or []:
                print(f"  [{w.start:.2f} - {w.end:.2f}] {w.word}")

    def finish():
        metrics_path = os.environ.get("ASR_METRICS")
        if metrics_path:
            dump_metrics(metrics_path)
        return 0

    try:
        engine = AsrEngine(model_path, dtype=dtype, max_new_tokens=max_new,
                           device=device, quantize=quantize,
                           speculative=draft, spec_k=draft_k,
                           draft_model=draft_model)
        sampling = None
        if sample_opts["temperature"] != 0 or any(
            sample_opts[k] != d
            for k, d in (("top-k", 0), ("top-p", 1.0), ("seed", 0))
        ):
            # validated whenever any sampling flag was given: a negative
            # --temperature or a --top-k without --temperature must
            # error or warn, not silently decode greedily
            sampling = SamplingParams(
                temperature=sample_opts["temperature"],
                top_k=sample_opts["top-k"],
                top_p=sample_opts["top-p"],
                seed=sample_opts["seed"],
            ).validate()
            if sampling.greedy:
                logger.warning(
                    "--top-k/--top-p/--seed have no effect without "
                    "--temperature > 0; decoding greedily"
                )
                sampling = None
        if len(audio_files) == 1:
            logger.info("Transcribing: %s", audio_files[0])
            result = engine.transcribe(audio_files[0], language,
                                       sampling=sampling)
            print(f"Language: {result.language}")
            print(f"Text: {result.text}")
            if timestamps:
                print_segments(result.segments)
            if engine.last_spec_stats:
                st = engine.last_spec_stats
                logger.info(
                    "speculative decode: %d tokens in %d iterations "
                    "(mean accepted drafts %.2f of %d)",
                    st["tokens"], st["iterations"], st["mean_accepted"],
                    draft_k)
            return finish()
        logger.info("Transcribing %d files as one batch", len(audio_files))
        samples = [load_audio(f, 16000) for f in audio_files]
        results = engine.transcribe_batch(samples, [language] * len(samples),
                                          sampling=sampling)
        for f, s, result in zip(audio_files, samples, results):
            print(f"File: {f}")
            print(f"Language: {result.language}")
            print(f"Text: {result.text}")
            if timestamps:
                # one whole-file span per file, as transcribe() gives
                # short audio
                print_segments(attach_words(
                    [Segment(0, 0.0, len(s) / 16000, result.text)]
                    if result.text.strip() else []))
        return finish()
    except (AsrError, ValueError, NotImplementedError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
