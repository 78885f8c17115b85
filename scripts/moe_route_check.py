#!/usr/bin/env python3
"""Where the ``deepseek_v3`` decoder in bf16 leaves the float32 reference,
and what the weight draw's scale does to it: per MoE layer, the share of
(token, layer) routes whose chosen experts differ from the reference's;
the check's readings of the program and of the fp8 control; the experts
a decode step touches.

    python3 scripts/moe_route_check.py [--seed N] [--rows 8] \
        [--scales 0.05] [--layers 27]

For each scale: the offline cell's (``kimivl-a3b-batch-b64``) traffic and
weights from the seed, drawn at that ``weight_init`` scale; one batch of
64 clips through ``AsrEngine.transcribe_batch``; then for ``--rows`` of
its rows, each row's prompt and served tokens once more through the
program's prefill (``DeepseekV3Decoder.prefill``, the routes recorded at
every MoE layer), through the benchmark's reference
(``reference/kimi_vl_asr.py``, float32, its routes recorded the same way)
and through a second witness that shares no code with the program: the
same reference with every product's operands and result rounded to bf16
(``Bf16Products``), the rounding a bf16 program makes, in another place.
If the witness leaves the float32 reference's routes at the first MoE
layer as often as the program does, the program's flips there are bf16
rounding of near-tied scores; a program that flips far more often than
the witness points at its arithmetic. The witness is also read as the
check reads a control (its own best token at each of the program's
positions, held to the float32 reference): the gaps that bf16 rounding
alone gives. Prints one JSON line per scale.
"""

from __future__ import annotations

import argparse
import copy
import gc
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from harness.caches import fix_cache_dirs  # noqa: E402

fix_cache_dirs()

import torch  # noqa: E402

from harness import check  # noqa: E402
from harness.program import engine as make_engine  # noqa: E402
from harness.program import token_ids  # noqa: E402
from harness.runner import Context  # noqa: E402
from harness.spec import load_cell  # noqa: E402
from harness.weights import make_weights  # noqa: E402

CELL = "kimivl-a3b-batch-b64"


def _pct(differ, n) -> list:
    return [round(100 * float(x) / max(n, 1), 2) for x in differ]


def run_scale(cell, cfg, seed: int, rows: int, device: str = "cuda") -> dict:
    from qwen3_asr_rs_tpu_torch.models import deepseek_v3_decoder as dv3

    arch = cell.architecture()
    t = arch.text_config(cfg)
    n_moe = t["num_hidden_layers"] - t["first_k_dense_replace"]
    traffic = cell.generator().generate(cell.mix, seed, 10.0)
    enc, dec = make_weights(cfg, seed, device)
    ctx = Context(cell, seed, 10.0, device, enc, dec, traffic)
    eng = make_engine(ctx, cell.mix["engine"]["max_new_tokens"])
    clips = traffic.batches[0]
    out = eng.transcribe_batch([c.samples for c in clips])
    toks = [token_ids(r) for r in out]
    touched = eng.last_stats["experts_touched"]

    base = type(cell.reference().Reference(cfg, enc, dec, device))

    class Bf16Products(base):
        """The reference with every product's operands and result
        rounded to bf16."""

        def _mm(self, x, w):
            return (x.bfloat16().float() @ w.bfloat16().float()
                    ).bfloat16().float()

    recorded: dict = {"program": [], "ref": [], "witness": []}
    route = dv3.route

    def rec_route(x, w, bias, *a, **kw):
        routes = route(x, w, bias, *a, **kw)
        recorded["program"].append(routes.ids.sort(-1).values)
        return routes

    moe = base._moe

    def rec_moe(self, x, j):
        m = self.dec["moe"]
        scores = torch.sigmoid(self._mm(x, m["router_w"][j]))
        ids = torch.topk(scores + m["router_bias"][j].float(),
                         self.t["num_experts_per_tok"], dim=-1).indices
        recorded[self.who].append(ids.sort(-1).values)
        return moe(self, x, j)

    ref = base(cfg, enc, dec, device)
    ref.who = "ref"
    wit = Bf16Products(cfg, enc, dec, device)
    wit.who = "witness"
    ctrl = base(cfg, enc, dec, device, matmul="fp8")
    ctrl.who = "control"
    recorded["control"] = []
    dv3.route = rec_route
    base._moe = rec_moe
    differ = {k: torch.zeros(n_moe) for k in ("program", "witness",
                                               "program_vs_witness")}
    n_pos = 0
    items = []
    try:
        for i in range(rows):
            samples = clips[i].samples
            for v in recorded.values():
                v.clear()
            with torch.inference_mode():
                hidden, (true_len,), _ = eng._embed_prompts(
                    [samples], [None], aligned=False)
                hidden = hidden[:, :true_len]
                ids = torch.tensor(toks[i], device=device, dtype=torch.long)
                hidden = torch.cat([hidden, eng.decoder.embed(
                    eng.dec_params, ids)[None]], 1)
                n = hidden.shape[1]
                cache = eng.decoder.cache_type.zeros(
                    eng.decoder.cfg, 1, n, dtype=eng.dtype, device=device)
                eng.decoder.prefill(eng.dec_params, hidden,
                                    torch.arange(n, device=device), cache, n)
            ref.continuation_logits(samples, toks[i])
            wit.continuation_logits(samples, toks[i])
            for j in range(n_moe):
                p = recorded["program"][j].reshape(n, -1)
                r, w = recorded["ref"][j], recorded["witness"][j]
                differ["program"][j] += (p != r).any(-1).sum().cpu()
                differ["witness"][j] += (w != r).any(-1).sum().cpu()
                differ["program_vs_witness"][j] += (
                    p != w).any(-1).sum().cpu()
            n_pos += n
            items.append({"samples": samples, "tokens": toks[i],
                          "cap": cell.mix["engine"]["max_new_tokens"],
                          "seconds": clips[i].seconds})
        readings = check.readings(ref, items, cfg["eos_token_ids"], ctrl)
        wit_readings = check.readings(ref, items, cfg["eos_token_ids"], wit)
    finally:
        dv3.route = route
        base._moe = moe
    res = {
        "scale": cfg["weight_init"]["scale"], "seed": seed, "rows": rows,
        "layers": t["num_hidden_layers"], "positions": n_pos,
        "experts_touched_per_layer": round(
            sum(touched) / max(len(touched), 1) / n_moe, 2),
        "routes_differ_pct": {k: _pct(v, n_pos) for k, v in differ.items()},
        "routes_differ_pct_all": {
            k: round(100 * float(v.sum()) / (n_moe * n_pos), 3)
            for k, v in differ.items()},
        **readings,
        "witness": {k: wit_readings[f"control_{k}"] for k in
                    ("max_gap", "mean_gap", "mismatch_pct")},
    }
    del eng, ref, wit, ctrl, enc, dec, ctx
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3000000001)
    ap.add_argument("--rows", type=int, default=8)
    ap.add_argument("--scales", default=None,
                    help="comma-separated weight_init scales (default: "
                         "the configuration's)")
    ap.add_argument("--layers", type=int, default=None)
    args = ap.parse_args()
    cell = load_cell(CELL)
    scales = ([float(s) for s in args.scales.split(",")] if args.scales
              else [cell.config["weight_init"]["scale"]])
    for s in scales:
        cfg = copy.deepcopy(cell.config)
        cfg["weight_init"]["scale"] = s
        if args.layers:
            cfg["num_hidden_layers"] = args.layers
        print(json.dumps(run_scale(cell, cfg, args.seed, args.rows)),
              flush=True)


if __name__ == "__main__":
    main()
