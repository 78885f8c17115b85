#!/usr/bin/env python3
"""How strong chip_smoke's element check of K1's bf16 GEMV is, on one CUDA
GPU: the real kernel passes it, kernels with a planted fault fail it.

    python3 scripts/gemv_check_strength.py

Builds K1 (``csrc/decode_layer.cu``) from the checkout, and again with one
planted fault each, from copies of ``csrc/`` in a temporary directory:

- ``last_split_dropped``: the last block of a column tile adds every K
  split's partial but the last;
- ``group_scale_skipped``: int4g's first group (rows 0 .. gsize - 1)
  joins the sum unscaled;
- ``wgmma_rank_dropped``: the wgmma GEMV's owners add every cluster
  rank's partial but the last;
- ``wgmma_rank_twice``: the wgmma GEMV's owners add rank 0's partial
  twice.

Every build runs every case of chip_smoke's GEMV phase (``gemv_single``:
every weight kind and epilogue at the 0.6B widths, B = 1, 8 and 32, on
the route the rule picks; and the wgmma GEMV, forced, at the 1.7B and
0.6B shapes of WGMMA_SHAPES, B = 1, 8 and 32) and applies its element
check (``ELEMENT_TOL["gemv_single"]`` against the
float32 reference with the kernel's roundings), and for comparison K1's
whole-step bound (``TOL``: max|err| <= 1e-2 + 2^-4 max|ref|). One JSON
line per (build, case), with ``changed``, the largest change of the
output from the real kernel's, then a summary per fault and the card.
Exits 1 unless the real kernel passes the element check in every case
and each fault fails it in every case where the fault changes the output.
Imports nothing of JAX; exits 1 without a CUDA device.
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

# (fault, source file, text, text with the fault)
FAULTS = (
    ("last_split_dropped", "decode_layer.cu",
     "for (int ks = 0; ks < nk; ++ks) {\n#pragma unroll\n"
     "        for (int which = 0; which < NACC; ++which) {\n"
     "          const float4 v",
     "for (int ks = 0; ks < nk - (nk > 1); ++ks) {\n#pragma unroll\n"
     "        for (int which = 0; which < NACC; ++which) {\n"
     "          const float4 v"),
    ("group_scale_skipped", "decode_layer.cu",
     "const float s = sc[v * GM_TN + gm_col<WK>(warp, lane, c >> 1)];",
     "const float s = done <= a.gsize ? 1.f : "
     "sc[v * GM_TN + gm_col<WK>(warp, lane, c >> 1)];"),
    ("wgmma_rank_dropped", "decode_layer.cu",
     "for (int r = 0; r < cs; ++r) {",
     "for (int r = 0; r < cs - (cs > 1); ++r) {"),
    ("wgmma_rank_twice", "decode_layer.cu",
     "for (int r = 0; r < cs; ++r) {\n#pragma unroll\n"
     "        for (int src = 0; src < NSRC; ++src) {\n"
     "          const float4 v = *reinterpret_cast<const float4*>(\n"
     "              red + ((r * NSRC + src)",
     "for (int r = -(cs > 1); r < cs; ++r) {\n#pragma unroll\n"
     "        for (int src = 0; src < NSRC; ++src) {\n"
     "          const float4 v = *reinterpret_cast<const float4*>(\n"
     "              red + (((r < 0 ? 0 : r) * NSRC + src)"),
)


def build_faults(build, tmp: Path) -> dict:
    """{fault: library path}: each fault's copy of csrc/ built with the
    port's nvcc flags, all in parallel."""
    procs = {}
    for fault, src, old, new in FAULTS:
        csrc = tmp / fault
        shutil.copytree(build.CSRC_DIR, csrc)
        text = (csrc / src).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{fault}: the text to change occurs "
                                 f"{text.count(old)} times in {src}")
        (csrc / src).write_text(text.replace(old, new))
        lib = csrc / "libdecode_layer.so"
        procs[fault] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / "decode_layer.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
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
        print("gemv_check_strength: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_layer as dl

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build(("decode_layer",))
    gen = torch.Generator(device="cuda").manual_seed(21)
    cases = []
    for kind, epilogue, nibbles in smoke.GEMV_CASES:
        for rows in smoke.GEMV_ROWS:
            x, w, s, kw = smoke.gemv_single_inputs(torch, gen, kind, epilogue,
                                                   nibbles, rows)
            ref, slack = dl.gemv_single_reference(x, w, s, **kw)
            name = (f"{kind} {epilogue}{' (nibbles)' if nibbles else ''} "
                    f"B={rows}")
            cases.append((name, (x, w, s, kw), ref, slack))
    for label, k, cols, epilogue in smoke.WGMMA_SHAPES:
        for rows in smoke.GEMV_ROWS:
            x, w, kw = smoke.gemv_wgmma_inputs(torch, gen, k, cols, epilogue,
                                               rows)
            ref, slack = dl.gemv_single_reference(
                x, torch.cat(w, 1) if isinstance(w, list) else w, None, **kw)
            cases.append((f"wgmma {label} B={rows}",
                          (x, w, None, {**kw, "route": "wgmma"}), ref, slack))
    atol, _ = smoke.ELEMENT_TOL["gemv_single"]
    tatol, trtol = smoke.TOL[("decode_layers_fused", "bfloat16")]
    tmp = Path(tempfile.mkdtemp(prefix="gemv_check_strength_"))
    rows, real = [], {}
    try:
        builds = [("real", _build.library_path("decode_layer"))] + list(
            build_faults(_build, tmp).items())
        for fault, path in builds:
            _build._libs["decode_layer"] = ctypes.CDLL(str(path))
            for name, (x, w, s, kw), ref, slack in cases:
                got = dl.gemv_single(x, w, s, **kw)
                torch.cuda.synchronize()
                if fault == "real":
                    real[name] = got
                excess = smoke.gemv_excess(torch, got, ref, slack)
                err = float((got.float() - ref).abs().max())
                row = {"build": fault, "case": name, "element_excess": excess,
                       "element_atol": atol, "element_ok": excess <= atol,
                       "max_abs_err": err,
                       "k1_step_bound": tatol + trtol * float(ref.abs().max()),
                       "changed": float((got.float() - real[name].float())
                                        .abs().max()),
                       "card": card}
                row["k1_step_ok"] = err <= row["k1_step_bound"]
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ok = all(r["element_ok"] for r in rows if r["build"] == "real")
    print(json.dumps({"summary": {
        "build": "real", "cases": len(cases),
        "largest_excess": max(r["element_excess"] for r in rows
                              if r["build"] == "real")}}), flush=True)
    for fault, *_ in FAULTS:
        active = [r for r in rows if r["build"] == fault and r["changed"] > 0]
        summary = {"build": fault, "active": len(active),
                   "failed_element": sum(not r["element_ok"] for r in active),
                   "passed_k1_step_bound": sum(r["k1_step_ok"]
                                               for r in active),
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
