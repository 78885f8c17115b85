"""The ``kimi-vl-a3b-asr`` configuration and its cell: the architecture's
counts pinned at the published widths, the cell loaded from
BENCHMARK.json with its files, a whole run of its harness on the CPU at
a tiny size (``correct`` true, and false with a fault planted in the
program's experts), and the routed-expert metrics on synthetic records.
"""

from __future__ import annotations

import copy

import pytest
import torch

from tiny import BENCH, ROOT, tiny_mix

from harness import moe as moe_mod
from harness import work
from harness.runner import run_cell
from harness.spec import Cell, load_cell, load_module, read_json

NEW = "kimivl-a3b-batch-b64"
SEED = 2 ** 31 + 91
ARCH = load_module(BENCH / "architectures" / "deepseek_v3.py")
REAL = read_json(BENCH / "configs" / "kimi-vl-a3b-asr.json")


def test_published_widths_count_15_96_billion_weights():
    """Every leaf at Kimi-VL-A3B's widths: the embedding and lm_head
    (0.67 B), 27 MLA layers, one dense MLP, 26 MoE layers of 64 experts
    (28.8 GB in bf16) and their shared experts."""
    leaves = ARCH.decoder_leaves(REAL)
    total = sum(torch.Size(s).numel() for s, _ in leaves.values())
    assert total == 15_960_110_208
    routed = sum(torch.Size(s).numel() for k, (s, _) in leaves.items()
                 if k.startswith("moe/experts"))
    assert routed == 26 * 64 * ARCH.expert_weights(REAL)
    assert 2 * routed == pytest.approx(28.8e9, rel=0.01)
    assert leaves["moe/experts_gate_up_w"][0] == (26, 64, 2048, 2816)
    assert leaves["layers/kv_b_w"][0] == (27, 512, 16 * 256)


def test_a_steps_bytes_follow_the_experts_it_touched():
    """One step of 64 rows, 500 stale latents each: every weight but the
    routed experts, the touched experts, the latents read and written."""
    live = [500] * 64
    full, ops = ARCH.decode_step_work(REAL, live, stats={
        "experts_touched": [1664]}, step=0)
    none, ops0 = ARCH.decode_step_work(REAL, live)
    expert = 2 * ARCH.expert_weights(REAL)
    assert full - none == 1664 * expert
    assert ops == ops0
    latents = 27 * (500 * 64 + 64) * 576 * 2
    leaves = ARCH.decoder_leaves(REAL)
    unrouted = sum(torch.Size(s).numel() for k, (s, _) in leaves.items()
                   if not k.startswith(("moe/experts", "embed")))
    assert none == 2 * unrouted + latents + 2 * 64 * 2048 * 2
    # the step is bound by its bytes: 32.2 GB with 64 experts touched in
    # each of the 26 MoE layers, 28.8 GB of them the experts'
    assert work.bound_s(full, ops) == pytest.approx(full / 3.35e12)
    assert full == pytest.approx(32.2e9, rel=0.01)


def test_the_cell_loads_from_benchmark_json():
    cell = load_cell(NEW)
    assert (cell.chips, cell.config["architecture"]) == (1, "deepseek_v3")
    assert cell.mix["arrival"]["batch"] == 64
    assert cell.check["sample"] == 32
    assert cell.architecture().__file__ == str(
        BENCH / "architectures" / "deepseek_v3.py")
    assert cell.reference().Reference.__name__ == "Reference"
    e2e = {m["name"] for m in cell.end_to_end}
    assert e2e == {"setup_s", "audio_s_per_s"}
    layers = {m["name"] for m in cell.per_layer}
    dense = {m["name"] for m in load_cell("asr17-batch-b32").per_layer}
    assert layers == dense | {"moe_experts_roofline.offline",
                              "moe_share_pct.offline",
                              "prefill_moe_share_pct.offline"}
    for m in cell.per_layer:
        cell.metric(m["name"])


def tiny_config() -> dict:
    cfg = copy.deepcopy(REAL)
    cfg["dtype"] = "float32"
    cfg["weight_init"] = {"scale": 0.3}
    cfg["thinker_config"]["audio_config"].update(
        d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, downsample_hidden_size=32, output_dim=64)
    cfg.update(
        vocab_size=151936, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, n_shared_experts=1, n_routed_experts=8,
        num_experts_per_tok=2, kv_lora_rank=32, qk_nope_head_dim=16,
        qk_rope_head_dim=8, v_head_dim=16)
    return cfg


def tiny_cell(limit: float = 1e-3) -> Cell:
    real = load_cell(NEW)
    return Cell(name="tiny-kimi", chips=1, config=tiny_config(),
                mix=tiny_mix("batch"),
                check={"sample": 4, "limits": {"max_gap": limit}},
                end_to_end=real.end_to_end, per_layer=real.per_layer,
                bench_dir=BENCH)


def test_sound_run_is_correct():
    out, values = run_cell(tiny_cell(), SEED, 2.0, False, "cpu")
    assert out["correct"], (out["checks"], values)
    assert values["tokens"] > 20
    assert out["metrics"]["audio_s_per_s"]["value"] > 0


@pytest.fixture
def plant(monkeypatch):
    """plant(kind): route each token to one expert fewer ('top_k'), or
    leave the shared experts out ('shared')."""
    from qwen3_asr_rs_tpu_torch.models import deepseek_v3_decoder as dv3

    def go(kind):
        if kind == "top_k":
            route = dv3.route

            def fewer(x, w, bias, top_k, *a, **kw):
                return route(x, w, bias, top_k - 1, *a, **kw)

            monkeypatch.setattr(dv3, "route", fewer)
        else:
            swiglu = dv3._swiglu

            def no_shared(x, gate_w, up_w, down_w):
                y = swiglu(x, gate_w, up_w, down_w)
                return y * 0 if gate_w.shape[1] == 32 else y

            monkeypatch.setattr(dv3, "_swiglu", no_shared)

    return go


@pytest.mark.parametrize("fault", ["top_k", "shared"])
def test_broken_experts_are_not_correct(plant, fault):
    plant(fault)
    out, values = run_cell(tiny_cell(), SEED, 2.0, False, "cpu")
    assert not out["correct"], (out["checks"], values)
    assert out["checks"]["max_gap"]["value"] > 100 * out["checks"][
        "max_gap"]["limit"]


def test_the_import_walk_sees_the_new_files():
    from test_bench_imports import RUN_FILES, imported_tops

    names = {p.relative_to(BENCH).as_posix() for p in RUN_FILES}
    new = {"architectures/deepseek_v3.py", "reference/kimi_vl_asr.py",
           "harness/moe.py", "metrics/moe_share_pct.offline.py",
           "metrics/moe_experts_roofline.offline.py",
           "metrics/prefill_moe_share_pct.offline.py"}
    assert new <= names
    for p in new:
        assert not imported_tops(BENCH / p) & {"jax", "jaxlib", "flax",
                                               "qwen3_asr_rs_tpu"}


COUNTERS = {"moe.decode_experts_touched": 127 * 1660,
            "moe.decode_rows": 127 * 26 * 64 * 6,
            "moe.prefill_experts_touched": 1664,
            "moe.prefill_rows": 26 * 6 * 10_000,
            "moe.max_expert_rows": 2000}


def _metric(name):
    return load_module(BENCH / "metrics" / f"{name}.py")


class _Slice:
    prof = object()


OPS = {"void (anonymous namespace)::moe_experts_kernel<16, true>(...)": 1.0,
       "void (anonymous namespace)::moe_experts_kernel<64, true>(...)": 0.2,
       "void (anonymous namespace)::moe_experts_kernel<16, false>(...)": 0.8,
       "nvjet_tst_128x": 0.5}


def test_expert_metrics_read_the_kernel_and_the_counters(monkeypatch):
    """The kernel's seconds are summed over every device operation of the
    run's profile (not the breakdown's top entries, which here name
    none of them), the bound by the running cell's architecture."""
    rec = {"trace": {"window_s": 4.0, "busy_s": 3.5, "device_ops": [
        ["nvjet_tst_128x", 0.5]]}}
    ctx = {"cell": load_cell(NEW), "sl": _Slice()}
    monkeypatch.setattr(moe_mod, "run_context", lambda: ctx)
    monkeypatch.setattr(moe_mod, "device_ops", lambda sl: OPS)
    monkeypatch.setattr(moe_mod, "counters", lambda: COUNTERS)
    assert _metric("moe_share_pct.offline").read(rec) == pytest.approx(50.0)
    bound = 0.0
    for phase in ("decode", "prefill"):
        bound += work.bound_s(*ARCH.expert_work(
            REAL, COUNTERS[f"moe.{phase}_experts_touched"],
            COUNTERS[f"moe.{phase}_rows"]))
    got = _metric("moe_experts_roofline.offline").read(rec)
    assert got == pytest.approx(100 * bound / 2.0)
    assert 0 < got < 100
    # nothing to read: no kernel in the slice, no counters, no cell
    monkeypatch.setattr(moe_mod, "device_ops", lambda sl: {"gemv": 1.0})
    assert _metric("moe_share_pct.offline").read(rec) is None
    assert _metric("moe_experts_roofline.offline").read(rec) is None
    monkeypatch.setattr(moe_mod, "device_ops", lambda sl: OPS)
    monkeypatch.setattr(moe_mod, "counters", lambda: {})
    assert _metric("moe_experts_roofline.offline").read(rec) is None
    monkeypatch.setattr(moe_mod, "counters", lambda: COUNTERS)
    monkeypatch.setattr(moe_mod, "run_context", lambda: {})
    assert _metric("moe_experts_roofline.offline").read(rec) is None
    assert _metric("moe_share_pct.offline").read(rec) is None
    assert _metric("moe_share_pct.offline").read({"trace": None}) is None


def test_run_context_is_the_running_cells(monkeypatch):
    """The metrics find the cell and the slice in the ``run_cell`` frame
    that reads them, whatever the command line says, and nothing outside
    one."""
    from harness import runner

    monkeypatch.setattr("sys.argv", ["pytest"])
    assert moe_mod.run_context() == {}

    def run_cell(cell, sl):
        return _metric("moe_share_pct.offline").read(
            {"trace": {"window_s": 4.0}})

    monkeypatch.setattr(runner, "run_cell", run_cell)
    monkeypatch.setattr(moe_mod, "device_ops", lambda sl: OPS)
    assert run_cell(load_cell(NEW), _Slice()) == pytest.approx(50.0)
    assert run_cell(load_cell(NEW), None) is None


def test_device_ops_sum_every_event_of_the_profile(monkeypatch):
    """K7's seconds come from every device event, however many other
    operations the slice ran (the record's breakdown keeps the top
    ``trace.TOP``)."""
    from harness import trace

    events = [(True, f"op{i}", 0.0, 1e6) for i in range(3 * trace.TOP)]
    events += [(True, "moe_experts_kernel<16, true>", 0.0, 1e4),
               (False, "moe_experts_kernel<16, true>", 0.0, 9e9)]
    sl = _Slice()
    monkeypatch.setattr(trace, "_events", lambda prof: events)
    ops = moe_mod.device_ops(sl)
    assert len(ops) == 3 * trace.TOP + 1
    assert ops["moe_experts_kernel<16, true>"] == pytest.approx(0.01)


def test_counters_read_the_programs_registry(monkeypatch):
    from qwen3_asr_rs_tpu_torch.utils import tracing

    t = tracing.Timings()
    t.counters["moe.decode_rows"] = 7
    t.profiles = 1
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", t)
    assert moe_mod.counters() == {"moe.decode_rows": 7}
    t.unprofiled = 1  # recorded with no profiler: more than the slice
    assert moe_mod.counters() == {}
    assert ROOT.is_dir()


CONTROL_SEEDS = [2 ** 31 + 911, 2 ** 31 + 912, 2 ** 31 + 913]
CONTROL_SECONDS = 10.0  # the cell's own load: a few of its 64-clip batches


@pytest.mark.cuda
def test_cuda_control_is_not_correct_on_the_cell():
    """``test_bench_control.py``'s test for this cell, at its committed
    limit: the fp8 control comes out not correct on three seeds, the
    program correct."""
    if not torch.cuda.is_available():
        pytest.skip("the control runs at the cell's size on a CUDA card")
    control = load_module(BENCH / "control.py")
    runs = control.readings(load_cell(NEW), CONTROL_SEEDS, CONTROL_SECONDS)
    assert [r[4] for r in runs] == [False] * len(CONTROL_SEEDS), runs
    assert [r[2] for r in runs] == [True] * len(CONTROL_SEEDS), runs


@pytest.mark.cuda
def test_cuda_planted_fault_fails_the_cells_check(plant):
    """One expert fewer a token, on the card at the cell's own size and
    limit: the check reads the run not correct."""
    if not torch.cuda.is_available():
        pytest.skip("the cell runs on a CUDA card")
    plant("top_k")
    cell = load_cell(NEW)
    out, values = run_cell(cell, CONTROL_SEEDS[0], CONTROL_SECONDS, False,
                           "cuda")
    assert not out["correct"], (out["checks"], values)
