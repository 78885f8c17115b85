#!/usr/bin/env python3
"""How strong chip_smoke's checks of the bf16 attention kernels are, on one
CUDA GPU: the real kernels pass them, kernels with a planted fault fail.

    python3 scripts/attention_check_strength.py

Builds K3 (``csrc/flash_attention.cu``) and K2's standalone entry
(``csrc/decode_attention.cu``) from the checkout, and again with one
planted fault each, from copies of ``csrc/`` in a temporary directory:

- K3 ``last_tile_skipped``: a block whose keys span more than 4 tiles
  skips its last key tile (for a causal block the tile on its diagonal,
  with kv_valid the ragged tile at the end);
- K3 ``long_rows_last_tile_skipped``: the same, only in blocks whose
  keys span more than 40 tiles (rows past 2560 keys);
- K3 ``key_past_valid``: the mask lets key kv_valid in (one extra key);
- K2 ``last_tile_skipped``: a split of more than one 64-slot tile skips
  its last tile;
- K2 ``last_slot_dropped``: each row's live range ends at end_b - 1.

Every build runs every case (K3: the bf16 cases of chip_smoke.py and
tests/test_torch_cuda.py, 200 to 4736 tokens; K2: B = 1 and 8, S = 360
to 4992, bf16 and int8 slabs, G = 2 and 8), and both of chip_smoke's
checks are applied: the global one (``TOL``: max|err| <= atol + rtol *
max|plain|) and the per-element one (``ELEMENT_TOL`` against the float32
reference with the kernel's roundings). One JSON line per (kernel,
build, case), with ``changed``, the largest change of the output from
the real kernel's, then a summary per fault and the card. Exits 1 unless
the real kernels pass both checks in every case and the per-element
check fails every fault in every case where the fault changes the
output. Imports nothing of JAX; exits 1 without a CUDA device.
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

# (kernel, fault, source file, text, text with the fault)
FAULTS = (
    ("flash_attention", "last_tile_skipped", "flash_attention.cu",
     "    const int k0 = kt * FM_BK;\n",
     "    const int k0 = kt * FM_BK;\n"
     "    if (kt == kt1 - 1 && kt1 - kt0 > 4) continue;\n"),
    ("flash_attention", "long_rows_last_tile_skipped", "flash_attention.cu",
     "    const int k0 = kt * FM_BK;\n",
     "    const int k0 = kt * FM_BK;\n"
     "    if (kt == kt1 - 1 && kt1 - kt0 > 40) continue;\n"),
    ("flash_attention", "key_past_valid", "flash_attention.cu",
     "if (col >= valid || col < kbegin || (causal && col > row)) {",
     "if (col > valid || col < kbegin || (causal && col > row)) {"),
    ("decode_attention", "last_tile_skipped", "decode_attention.cuh",
     "    const unsigned char* st = stage(i % STAGES);\n",
     "    if (i == ntiles - 1 && i > 0) continue;\n"
     "    const unsigned char* st = stage(i % STAGES);\n"),
    ("decode_attention", "last_slot_dropped", "decode_attention.cuh",
     "end != nullptr ? end[b] : end_val), S);",
     "(end != nullptr ? end[b] : end_val) - 1), S);"),
)

# K3: (B, S, Hq, Hkv, D, causal, kv_valid, kv_start)
K3_CASES = (
    (1, 300, 16, 8, 128, True, None, None),
    (2, 777, 16, 8, 128, False, [700, 129], None),
    (1, 4736, 16, 8, 128, True, None, None),
    (1, 4736, 16, 8, 128, True, [4000], None),
    (1, 4736, 16, 8, 128, False, [3001], None),
    (2, 4736, 16, 8, 128, True, None, [0, 517]),
    (2, 1000, 16, 8, 64, True, None, [0, 333]),
    (1, 517, 4, 4, 128, True, None, None),
    (3, 200, 8, 1, 64, False, [200, 1, 64], None),
)
# K2: (B, S, Hq, Hkv, D, starts, ends, int8 slab)
K2_CASES = (
    (1, 360, 16, 8, 128, [0], [217], False),
    (1, 360, 16, 8, 128, [37], [301], True),
    (1, 4992, 16, 8, 128, [0], [4737], False),
    (8, 4992, 16, 8, 128, [0, 37, 129, 200, 5, 77, 150, 263], [4737] * 8,
     False),
    (8, 4992, 16, 8, 128, [0, 37, 129, 200, 5, 77, 150, 263], [4737] * 8,
     True),
    (3, 1000, 16, 2, 64, [0, 0, 900], [65, 999, 900], False),
)


def build_faults(build, tmp: Path) -> dict:
    """{(kernel, fault): library path}: each fault's copy of csrc/ built
    with the port's nvcc flags, all in parallel."""
    procs = {}
    for kernel, fault, src, old, new in FAULTS:
        csrc = tmp / f"{kernel}-{fault}"
        shutil.copytree(build.CSRC_DIR, csrc)
        text = (csrc / src).read_text()
        if text.count(old) != 1:
            raise AssertionError(f"{kernel} {fault}: the text to change "
                                 f"occurs {text.count(old)} times in {src}")
        (csrc / src).write_text(text.replace(old, new))
        lib = csrc / f"lib{kernel}.so"
        procs[(kernel, fault)] = (subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{kernel}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), lib)
    libs = {}
    for key, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        libs[key] = lib
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_check_strength: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    import chip_smoke as smoke
    from qwen3_asr_rs_tpu_torch.models.text_decoder import quantize_kv
    from qwen3_asr_rs_tpu_torch.ops.kernels import _build
    from qwen3_asr_rs_tpu_torch.ops.kernels import decode_attention as da
    from qwen3_asr_rs_tpu_torch.ops.kernels.flash_attention import (
        flash_attention, flash_attention_plain, flash_attention_tile_reference)

    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    _build.build(("flash_attention", "decode_attention"))
    real = {n: _build.library_path(n)
            for n in ("flash_attention", "decode_attention")}
    tmp = Path(tempfile.mkdtemp(prefix="attention_check_strength_"))
    try:
        libs = build_faults(_build, tmp)
        builds = [(n, "real", p) for n, p in real.items()] + [
            (k, f, p) for (k, f), p in libs.items()]
        dev = torch.device("cuda")

        def use(kernel, path):
            """Point the wrapper of ``kernel`` at the library ``path``."""
            _build._libs[kernel] = ctypes.CDLL(str(path))
            da._workspaces.clear()

        # K3 cases: inputs, the compared rows of each example, the plain
        # version and the tile reference, made once
        k3 = []
        gen = torch.Generator(device=dev).manual_seed(5)
        for b, s, hq, hkv, d, causal, kv_valid, kv_start in K3_CASES:
            q, k, v = (torch.randn((b, s, h, d), generator=gen,
                                   device=dev).bfloat16()
                       for h in (hq, hkv, hkv))
            valid, start = (None if x is None else torch.tensor(
                x, dtype=torch.int32, device=dev) for x in (kv_valid, kv_start))
            keep = torch.ones((b, s), dtype=torch.bool, device=dev)
            for i in range(b):
                if causal and kv_start is not None:
                    keep[i, :kv_start[i]] = False  # no attendable key
                if kv_valid is not None and kv_valid[i] < 1:
                    keep[i] = False
            name = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} causal={causal} "
                    f"kv_valid={kv_valid} kv_start={kv_start}")
            call = (lambda q=q, k=k, v=v, valid=valid, start=start,
                    causal=causal: flash_attention(q, k, v, valid, start,
                                                   causal=causal))
            k3.append((name, call, keep,
                       flash_attention_plain(q, k, v, valid, start,
                                             causal=causal),
                       flash_attention_tile_reference(q, k, v, valid, start,
                                                      causal=causal)))
        k2 = []
        for b, s, hq, hkv, d, starts, ends, int8 in K2_CASES:
            ks, vs = (torch.randn((2, b, hkv, s, d), generator=gen,
                                  device=dev) for _ in range(2))
            scales = {}
            if int8:
                (ks, kscale), (vs, vscale) = quantize_kv(ks), quantize_kv(vs)
                scales = dict(k_scales=kscale, v_scales=vscale)
            else:
                ks, vs = ks.bfloat16(), vs.bfloat16()
            q = torch.randn((b, hq, d), generator=gen, device=dev).bfloat16()
            k_self, v_self = (torch.randn((b, hkv, d), generator=gen,
                                          device=dev).bfloat16()
                              for _ in range(2))
            st, en = (torch.tensor(x, dtype=torch.int32, device=dev)
                      for x in (starts, ends))
            args = (ks, vs, k_self, v_self, 1, st, en)
            name = (f"B={b} S={s} Hq={hq} Hkv={hkv} D={d} start={starts} "
                    f"end={ends} slab={'int8' if int8 else 'bf16'}")
            call = (lambda q=q, args=args, scales=scales:
                    da.decode_attention_dma(q, *args, **scales))
            keep = torch.ones((b,), dtype=torch.bool, device=dev)
            k2.append((name, call, keep,
                       da.decode_attention_dma_plain(q, *args, **scales),
                       da.decode_attention_dma_plain(q.float(), *args,
                                                     **scales)))

        cases = {"flash_attention": (k3, "flash_attention"),
                 "decode_attention": (k2, "decode_attention_dma")}
        outs = {}
        rows = []
        for kernel, fault, path in builds:
            use(kernel, path)
            group, tol_name = cases[kernel]
            atol, rtol = smoke.TOL[(tol_name, "bfloat16")]
            eatol, ertol = smoke.ELEMENT_TOL[tol_name]
            for name, call, keep, plain, ref32 in group:
                got = call()
                torch.cuda.synchronize()
                if fault == "real":
                    outs[(kernel, name)] = got
                err = float((got.float() - plain.float()).abs()[keep].max())
                bound = atol + rtol * float(plain.float().abs()[keep].max())
                excess = smoke.element_excess(torch, got[keep], ref32[keep],
                                              ertol)
                row = {"kernel": kernel, "build": fault, "case": name,
                       "max_abs_err": err, "global_bound": bound,
                       "global_ok": err <= bound, "element_excess": excess,
                       "element_atol": eatol, "element_rtol": ertol,
                       "element_ok": excess <= eatol,
                       "changed": float((got.float() - outs[(kernel, name)]
                                         .float()).abs()[keep].max()),
                       "card": card}
                rows.append(row)
                print(json.dumps(row), flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    ok = all(r["global_ok"] and r["element_ok"]
             for r in rows if r["build"] == "real")
    for kernel, fault, *_ in FAULTS:
        mine = [r for r in rows if (r["kernel"], r["build"]) == (kernel, fault)]
        active = [r for r in mine if r["changed"] > 0]
        summary = {"kernel": kernel, "fault": fault,
                   "cases": len(mine), "active": len(active),
                   "failed_global": sum(not r["global_ok"] for r in active),
                   "failed_element": sum(not r["element_ok"] for r in active),
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
