"""What the drivers hand the program besides the weights: its
configuration object, a tokenizer stub, reading token ids back, and the
check that the program serves the configuration's stated precision.

The repository holds no ``tokenizer.json``, so the program decodes
through ``StubTokenizer``: its text is the token ids, which is what the
check compares. Decoding real text waits until tokenizer files are in
the repository.
"""

from __future__ import annotations


class StubTokenizer:
    """Token ids as text (``chip_smoke.py``'s stub)."""

    def encode(self, text):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def token_ids(result) -> list:
    """The token ids of a ``TranscribeResult`` decoded by StubTokenizer."""
    return [int(t) for t in result.raw_output.split()]


def engine(ctx, max_new_tokens: int):
    """The program's ``AsrEngine`` over the benchmark's weights, in the
    configuration's dtype and KV type."""
    from qwen3_asr_rs_tpu_torch.config import AsrConfig
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    from .weights import DTYPES

    cfg = ctx.cell.config
    return AsrEngine(None, config=AsrConfig.from_dict(cfg),
                     params=(ctx.enc, ctx.dec), tokenizer=StubTokenizer(),
                     device=ctx.device, dtype=DTYPES[cfg["dtype"]],
                     max_new_tokens=max_new_tokens,
                     kv_dtype=cfg["kv_dtype"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def check_precision(engine, config: dict, batcher=None) -> None:
    """Raise unless the program serves the configuration's precision:
    no quantized decoder (``engine.quantize`` None, every weight of the
    encoder and decoder in the configuration's ``dtype``), the stated
    KV type, and a batcher that decodes with the engine's own weights.
    The check's limits separate the sound runs from a lower precision
    only by a few times (PERF.md), so a lower precision the program
    switched on by itself is refused here, by what it states."""
    import torch

    from .weights import DTYPES

    want = DTYPES[config["dtype"]]
    found = []
    if getattr(engine, "quantize", None) is not None:
        found.append(f"quantize={engine.quantize!r}")
    if bool(getattr(engine, "kv_quant", False)) != (
            config["kv_dtype"] == "int8"):
        found.append(f"kv_quant={engine.kv_quant!r} for kv_dtype "
                     f"{config['kv_dtype']!r}")
    dtypes = {t.dtype for t in _leaves((engine.enc_params, engine.dec_params))
              if isinstance(t, torch.Tensor)}
    if dtypes != {want}:
        found.append(f"weights in {sorted(map(str, dtypes))}")
    if batcher is not None and batcher.serving_precision not in (
            "engine", "bf16"):
        found.append(f"serving_precision={batcher.serving_precision!r}")
    if found:
        raise RuntimeError(
            f"the program does not serve {config['dtype']} weights and "
            f"{config['kv_dtype']} KV as the configuration states: "
            + "; ".join(found))
