#!/usr/bin/env python3
"""How strong chip_smoke's element check of K5 (int8 quant_matmul) is, on
one CUDA GPU: the real kernel passes it, kernels with a planted fault fail
it.

    python3 scripts/k5_check_strength.py

Builds K5 (``csrc/quant_matmul.cu``) from the checkout, and again with one
planted fault each, from copies of ``csrc/`` in a temporary directory:

- ``k_stage_dropped``: the second 64-row K stage of every block (of a
  split) adds nothing, in the wgmma tiles and in the GEMV blocks;
- ``split_added_twice``: the split-K sum adds the first split's partial
  twice.

Every build runs every bf16 case of chip_smoke's K5 phase (``k5_cases``:
the 0.6B linears at the prefill rows, the ragged shape, the lm_head at 1
to 32 rows; weights quantized from seeded random values) and applies its
element check (``ELEMENT_TOL`` against ``k5_reference``), and for
comparison the whole-output bound (``TOL``). One JSON line per (build,
case), with ``changed``, the largest change of the output from the real
kernel's, then a summary per build and the card. Exits 1 unless the real
kernel passes the element check in every case and each fault fails it in
every case where the fault changes the output. Imports nothing of JAX;
exits 1 without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# (fault, [(text, text with the fault)]) in csrc/quant_matmul.cu
FAULTS = (
    ("k_stage_dropped", [
        ("qm_wgmma(acc, da + 128 * kk, db + 2 * kk);",
         "if (st != 1) qm_wgmma(acc, da + 128 * kk, db + 2 * kk);"),
        ("gm_mma(acc[nb], a, b);", "if (st != 1) gm_mma(acc[nb], a, b);")]),
    ("split_added_twice", [
        ("for (int ks = 0; ks < nk; ++ks) {",
         "for (int ks = nk > 1 ? -1 : 0; ks < nk; ++ks) {"),
        ("ws + ((size_t)ks * R + r) * N + c));",
         "ws + ((size_t)(ks < 0 ? 0 : ks) * R + r) * N + c));")]),
)


def build_faults(build, tmp: Path) -> dict:
    """{fault: library path}: each fault's copy of csrc/ built with the
    port's nvcc flags, all in parallel."""
    procs = {}
    for fault, edits in FAULTS:
        csrc = tmp / fault
        shutil.copytree(build.CSRC_DIR, csrc)
        src = csrc / "quant_matmul.cu"
        text = src.read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise AssertionError(f"{fault}: the text to change occurs "
                                     f"{text.count(old)} times")
            text = text.replace(old, new)
        src.write_text(text)
        lib = csrc / "libquant_matmul.so"
        procs[fault] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for fault, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{fault}: nvcc failed\n{log}")
        libs[fault] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("k5_check_strength: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.ops.kernels import quant_matmul as qm
    from qwen3_asr_rs_tpu_torch.ops.quant import quantize_weight

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build(("quant_matmul",))
    gen = torch.Generator(device="cuda").manual_seed(22)
    weights, cases = {}, []
    for weight, rows, k, n, logits in smoke.k5_cases():
        if (k, n) not in weights:
            weights[k, n] = quantize_weight(0.02 * torch.randn(
                (k, n), generator=gen, device="cuda"))
        w_q, s = weights[k, n]
        x = torch.randn((rows, k), generator=gen,
                        device="cuda").to(torch.bfloat16)
        out_dtype = torch.float32 if logits else torch.bfloat16
        dt = "bfloat16" + ("->float32" if logits else "")
        cases.append((smoke.k5_case_name(weight, rows, k, n, logits),
                      (x, w_q, s, out_dtype), smoke.k5_reference(x, w_q, s),
                      dt, qm.launch_plan(rows, k, n, False)))
    tmp = Path(tempfile.mkdtemp(prefix="k5_check_strength_"))
    rows, real = [], {}
    try:
        builds = [("real", _build.library_path("quant_matmul"))] + list(
            build_faults(_build, tmp).items())
        for fault, path in builds:
            _build._libs["quant_matmul"] = ctypes.CDLL(str(path))
            for name, (x, w_q, s, out_dtype), ref, dt, plan in cases:
                got = qm.quant_matmul(x, w_q, s, out_dtype=out_dtype)
                torch.cuda.synchronize()
                if fault == "real":
                    real[name] = got
                atol, rtol = smoke.ELEMENT_TOL[("quant_matmul", dt)]
                excess = smoke.element_excess(torch, got, ref, rtol)
                tatol, trtol = smoke.TOL[("quant_matmul", dt)]
                err = float((got.double() - ref).abs().max())
                row = {"build": fault, "case": name, "route": plan["route"],
                       "splits": plan["splits"], "element_excess": excess,
                       "element_atol": atol, "element_ok": excess <= atol,
                       "max_abs_err": err,
                       "global_bound": tatol + trtol * float(ref.abs().max()),
                       "changed": float((got.float() - real[name].float())
                                        .abs().max()),
                       "card": card}
                row["global_ok"] = err <= row["global_bound"]
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ok = all(r["element_ok"] for r in rows if r["build"] == "real")
    print(json.dumps({"summary": {
        "build": "real", "cases": len(cases),
        "largest_excess": max(r["element_excess"] for r in rows
                              if r["build"] == "real")}}), flush=True)
    for fault, _ in FAULTS:
        active = [r for r in rows if r["build"] == fault and r["changed"] > 0]
        summary = {"build": fault, "active": len(active),
                   "failed_element": sum(not r["element_ok"] for r in active),
                   "passed_global_bound": sum(r["global_ok"] for r in active),
                   "smallest_excess": min((r["element_excess"]
                                           for r in active), default=None),
                   "passed_element": [r["case"] for r in active
                                      if r["element_ok"]]}
        print(json.dumps({"summary": summary}), flush=True)
        if not active or summary["passed_element"]:
            ok = False
    print(card, flush=True)
    print(json.dumps({"ok": ok}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
