"""The harness on the CPU, with no card and no nvcc: cells, mixes,
drivers and metrics found by name; additions picked up without edits;
the generator's traffic from the seed; the yardstick's counts against
hand counts; BENCHMARK.json's names; the trace reduction; and a run
without a card failing instead of falling back to the CPU."""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys

import numpy as np
import pytest

from tiny import BENCH, ROOT, copy_bench, tiny_config

from harness import work
from harness.runner import sample_items
from harness.spec import (load_any_cell, load_cell, load_module, read_json,
                          with_held)
from harness.trace import merge, reduce_events

BENCHMARK = read_json(ROOT / "BENCHMARK.json")
CELLS = [w["name"] for w in BENCHMARK["workloads"]]
# with the held-back cells (held/<cell>.json), whose proof is still open
ALL_CELLS = [w["name"] for w in with_held(BENCHMARK)["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CLIPS = load_module(BENCH / "generators" / "clips.py")


# ----------------------------------------------------------- found by name

@pytest.mark.parametrize("name", ALL_CELLS)
def test_cell_files_found_by_name(name):
    cell = load_any_cell(name)
    assert hasattr(cell.generator(), "generate")
    assert hasattr(cell.driver(), "Session")
    assert hasattr(cell.reference(), "Reference")
    arch = cell.architecture()
    assert all(callable(getattr(arch, f)) for f in (
        "decoder_leaves", "prefill_flops", "decode_flops", "decode_step_work"))
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cell.metric(m["name"]).read)
    assert cell.check["limits"]
    assert cell.check["sample"] == "all" or cell.check["sample"] >= 1


def test_new_metric_and_cell_are_picked_up_without_edits(tmp_path):
    b, before = copy_bench(tmp_path)
    bench = json.loads(json.dumps(with_held(BENCHMARK)))
    new = "asr06-serve-bursty"
    bench["workloads"].append({
        "name": new, "config": "qwen3-asr-0.6b", "traffic": "serve-bursty",
        "chips": 1, "why": "bursts"})
    bench["per_layer"].append({
        "name": "queue_wait_ms.serve", "unit": "ms", "better": "lower",
        "source": "program_span", "layer": "serving scheduler",
        "moves": "latency_p95_ms", "workloads": [new]})
    for m in bench["end_to_end"]:
        if m["name"].startswith("latency_"):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = read_json(b / "traffic" / "serve-poisson.json")
    mix["arrival"] = {"kind": "poisson", "rate_per_s": 2.0}
    (b / "traffic" / "serve-bursty.json").write_text(json.dumps(mix))
    (b / "checks" / f"{new}.json").write_text(
        json.dumps({"sample": 4, "limits": {"max_gap": 1.0}}))
    (b / "metrics" / "queue_wait_ms.serve.py").write_text(
        "def read(rec):\n    return 42.0\n")
    cell = load_cell(new, bench_dir=b)
    assert cell.mix["arrival"]["rate_per_s"] == 2.0
    assert [m["name"] for m in cell.per_layer] == ["queue_wait_ms.serve"]
    assert cell.metric("queue_wait_ms.serve").read({}) == 42.0
    assert {m["name"] for m in cell.end_to_end} == {
        "setup_s", "latency_p95_ms", "latency_p50_ms"}
    # the old cells read as before; no file that was there changed
    old = load_cell("asr06-serve-poisson", bench_dir=b)
    assert "queue_wait_ms.serve" not in [m["name"] for m in old.per_layer]
    assert all(p.read_bytes() == data for p, data in before.items())
    traffic = cell.generator().generate(cell.mix, 7, 8.0)
    assert len(traffic.requests) == 16


# ----------------------------------------------------------- the generator

def _serve_mix():
    return read_json(BENCH / "traffic" / "serve-poisson.json")


def test_same_seed_same_traffic_other_seed_other_order():
    mix = _serve_mix()
    a = CLIPS.generate(mix, 2 ** 31 + 11, 10.0)
    b = CLIPS.generate(mix, 2 ** 31 + 11, 10.0)
    c = CLIPS.generate(mix, 2 ** 31 + 12, 10.0)
    n = round(mix["arrival"]["rate_per_s"] * 10.0)
    assert len(a.requests) == len(c.requests) == n
    for x, y in zip(a.requests, b.requests):
        assert x.due_s == y.due_s and x.max_new == y.max_new
        np.testing.assert_array_equal(x.samples, y.samples)
    assert [x.seconds for x in a.requests] != [x.seconds for x in c.requests]
    assert [x.due_s for x in a.requests] != [x.due_s for x in c.requests]
    assert not np.array_equal(a.requests[0].samples, c.requests[0].samples)
    # the same work in another order
    assert sorted(x.seconds for x in a.requests) == sorted(
        x.seconds for x in c.requests)


def test_open_loop_shape():
    mix = _serve_mix()
    t = CLIPS.generate(mix, 3, 30.0)
    due = [c.due_s for c in t.requests]
    secs = [c.seconds for c in t.requests]
    assert due == sorted(due) and due[0] == 0.0 and due[-1] < 30.0
    assert min(secs) >= 1.0 and max(secs) <= 120.0
    assert sum(s > 30 for s in secs) == round(0.04 * len(secs))
    for c in t.requests:
        assert c.max_new == math.ceil(3.5 * c.seconds) + 4
        assert len(c.samples) == round(c.seconds * 16000)


def test_closed_loop_batches_hold_the_same_lengths():
    mix = read_json(BENCH / "traffic" / "batch-b32.json")
    t = CLIPS.generate(mix, 99, 30.0)
    assert len(t.batches) == mix["arrival"]["pool"]
    sets = [sorted(c.seconds for c in b) for b in t.batches]
    assert all(s == sets[0] for s in sets) and len(sets[0]) == 32
    assert [c.seconds for c in t.batches[0]] != [c.seconds
                                                 for c in t.batches[1]]
    assert max(sets[0]) > 15.0  # every batch takes the 30-chunk bucket
    assert 2.0 <= min(sets[0])


def test_length_quantiles():
    comps = [{"share": 1.0, "dist": "lognormal", "median": 10.0,
              "sigma": 0.5, "min": 2.0, "max": 30.0}]
    v = CLIPS.lengths(comps, 3)
    assert v[1] == pytest.approx(10.0)
    assert v[0] == pytest.approx(10.0 * math.exp(-0.5 * 0.9674215661017))


# ----------------------------------------------------------- the yardstick

def test_decode_step_work_by_hand():
    cfg = tiny_config()
    # h 64, d 16, 4 query and 2 kv heads, inter 128, 2 layers, V 151936
    layer = 64 * (4 + 2 * 2) * 16 + 4 * 16 * 64 + 3 * 64 * 128
    assert work.layer_weights(cfg["thinker_config"]["text_config"]) == layer
    nbytes, ops = work.decode_step_work(cfg, [10, 20])
    weights = 2 * (layer + 2 * 64 + 2 * 16) + 64 + 151936 * 64
    kv_slot = 2 * 2 * 16 * 2  # K and V, 2 heads, 16 dims, bf16
    assert nbytes == (2 * weights + 2 * 30 * kv_slot + 2 * 2 * kv_slot
                      + 2 * 2 * 64 * 2)
    assert ops == 2 * 2 * (2 * layer + 151936 * 64) + 4 * 2 * 64 * (30 + 2)
    assert work.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert work.bound_s(0, 989e12) == pytest.approx(1.0)


def test_prefill_and_decode_flops_by_hand():
    cfg = tiny_config()
    layer = work.layer_weights(cfg["thinker_config"]["text_config"])
    p = 20
    want = 2 * p * 2 * layer + 2 * 2 * p * (p + 1) * 64 + 2 * 64 * 151936
    assert work.prefill_flops(cfg, p) == want
    # tokens 2 and 3 of a 3-token answer: steps at 21 and 22 positions
    per = 2 * (2 * layer + 64 * 151936)
    assert work.decode_flops(cfg, p, 3) == 2 * per + 4 * 2 * 64 * (21 + 22)
    assert work.decode_flops(cfg, p, 1) == 0


def test_encoder_flops_by_hand():
    cfg = tiny_config()
    # 250 frames: chunks of 100, 100, 50 -> 13 + 13 + 7 tokens, one window
    frames, tokens = work.audio_tokens(cfg, 250 * 160)
    assert (frames, tokens) == (250, 33)
    dh, d, ff, out = 32, 64, 128, 64
    stem = (2 * 1 * dh * 9 * 64 * 50 + 2 * dh * dh * 9 * 32 * 25
            + 2 * dh * dh * 9 * 16 * 13 + 2 * 13 * dh * 16 * d)
    layers = 2 * (2 * 33 * (4 * d * d + 2 * d * ff) + 4 * d * 33 * 33)
    head = 2 * 33 * (d * d + d * out)
    assert work.encoder_flops(cfg, 250) == 3 * stem + layers + head
    assert work.prompt_len(cfg, 250 * 160) == 9 + 33 + 6


def test_sample_keeps_the_longest_and_covers_every_stretch():
    items = [{"seconds": float(i % 7), "i": i} for i in range(32)]
    items[29]["seconds"] = 99.0
    got = sample_items(items, 8, 5)
    idx = [it["i"] for it in got]
    assert 29 in idx and len(idx) == 8
    assert [i // 4 for i in idx] == list(range(8))
    assert sample_items(items, 8, 5) == got


# ------------------------------------------------------------ the trace

def test_trace_reduction():
    ev = [(True, "k1", 0.0, 10.0), (True, "k2", 5.0, 20.0),
          (True, "k1", 30.0, 34.0), (False, "aten::conv2d", 18.0, 33.0),
          (False, "cudaLaunchKernel", 21.0, 22.0),
          (False, "python_op", -5.0, 60.0)]
    r = reduce_events(ev, 1e-4, "test")
    assert merge([(0, 10), (5, 20), (30, 34)]) == [[0, 20], [30, 34]]
    assert r["busy_s"] == pytest.approx(24e-6)
    assert r["device_ops"][0] == ["k2", pytest.approx(15e-6)]
    gaps = dict(r["idle_gaps"])
    assert gaps["aten::conv2d"] == pytest.approx(10e-6)  # 20..30
    assert gaps["python_op"] == pytest.approx(31e-6)  # -5..0 and 34..60


# --------------------------------------------------------- BENCHMARK.json

def test_benchmark_json_keys_names_and_units():
    b = BENCHMARK
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in b["paths"])
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = []
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names
        assert NAME.match(w["traffic"])
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        names.append(w["name"])
    assert {w["config"] for w in b["workloads"]} == {c["name"]
                                                    for c in b["configs"]}
    e2e = set()
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        e2e.add(m["name"])
        names.append(m["name"])
    assert "setup_s" in e2e
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        names.append(m["name"])
    assert len(names) == len(set(names))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for n in names:
        assert NAME.match(n), n
    for entry in b["configs"] + b["workloads"]:
        assert 1 <= len(entry["why"]) <= 200 and "\t" not in entry["why"]
    for p in BENCH.rglob("*"):
        assert PATH.match(p.relative_to(ROOT).as_posix()), p


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for name in ALL_CELLS:
        cell = load_any_cell(name)
        e2e = [m["name"] for m in cell.end_to_end]
        assert e2e[0] == "setup_s" and len(e2e) >= 2
        assert all(m["moves"] in e2e for m in cell.per_layer)


# ------------------------------------------------------------ no card

def test_a_run_without_a_card_fails():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", str(2 ** 31 + 5), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode not in (0,)
    assert out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


# ------------------------------------------------------ held-back cells

def test_held_cells_are_whole_and_out_of_the_runs():
    merged = with_held(BENCHMARK)
    held = [w["name"] for w in merged["workloads"] if w["name"] not in CELLS]
    assert held == ["asr06-serve-poisson"]
    for path in sorted((BENCH / "held").glob("*.json")):
        frag = read_json(path)
        assert frag["held_back"] and [w["name"] for w in
                                      frag["workloads"]] == [path.stem]
        for m in frag["end_to_end"]:
            assert "bound" not in m  # set when the cell is proved
    assert {m["name"] for m in merged["end_to_end"]} > {
        m["name"] for m in BENCHMARK["end_to_end"]}
    # a run reads BENCHMARK.json alone
    with pytest.raises(KeyError):
        load_cell(held[0])


def test_the_serving_mix_is_at_four_fifths_of_the_knee():
    assert _serve_mix()["arrival"]["rate_per_s"] == 0.8 * 10.0


# ------------------------------------------------------ the precision

def _engine(quantize=None, kv_quant=False, leaf=None):
    import torch
    from types import SimpleNamespace

    w = torch.zeros(2, 2, dtype=torch.bfloat16)
    dec = {"layers": [{"q": w, "k": w}], "lm_head": w}
    if leaf is not None:
        dec["layers"][0]["q_s"] = leaf
    return SimpleNamespace(quantize=quantize, kv_quant=kv_quant,
                           enc_params={"conv": w}, dec_params=dec)


@pytest.mark.parametrize("case", ["int8", "kv", "leaf", "f32", "batcher"])
def test_a_lower_precision_is_refused(case):
    import torch
    from types import SimpleNamespace

    from harness.program import check_precision

    cfg = {"dtype": "bfloat16", "kv_dtype": "bf16"}
    check_precision(_engine(), cfg)
    check_precision(_engine(), cfg, SimpleNamespace(
        serving_precision="engine"))
    bad = {"int8": (_engine(quantize="int8"), None),
           "kv": (_engine(kv_quant=True), None),
           "leaf": (_engine(leaf=torch.zeros(2, dtype=torch.int8)), None),
           "f32": (_engine(leaf=torch.zeros(2)), None),
           "batcher": (_engine(), SimpleNamespace(serving_precision="auto"))}
    engine, batcher = bad[case]
    with pytest.raises(RuntimeError, match="as the configuration states"):
        check_precision(engine, cfg, batcher)


def test_host_load_reads_a_busy_thread():
    from harness.host import HostLoad, line

    h = HostLoad()
    h.start()
    x = 0
    for i in range(200000):
        x += i
    import gc
    gc.collect()
    got = h.stop()
    assert got["wall_s"] > 0 and got["main_cpu_s"] > 0
    assert got["gc_n"] >= 1 and got["gc_s"] >= 0
    assert line(got).startswith("host: wall_s ")
