"""The decoder's weight layout and work counts belong to the architecture
that a configuration names (``architectures/<architecture>.py``): the
dense one gives exactly what the harness gave before they moved there,
and a configuration of another architecture joins as files alone."""

from __future__ import annotations

import hashlib
import json
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tiny import BENCH, copy_bench, tiny_config

from harness import work
from harness.spec import load_cell, load_module, read_json, with_held
from harness.weights import make_weights

BATCH = load_module(BENCH / "drivers" / "batch.py")
REAL = read_json(BENCH / "configs" / "qwen3-asr-1.7b.json")


def weights_digest(enc: dict, dec: dict) -> str:
    """sha256 of the whole buffer the leaves are views of, then of each
    leaf's name, shape and offset in it, in tree order."""
    first = enc["conv1_w"]
    store = first.untyped_storage()
    flat = torch.as_strided(first, (store.nbytes() // first.element_size(),),
                            (1,), 0)
    h = hashlib.sha256(flat.view(torch.uint8).cpu().numpy().tobytes())

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
                continue
            assert v.untyped_storage().data_ptr() == store.data_ptr()
            h.update(f"{prefix}{k}:{tuple(v.shape)}:{v.storage_offset()};"
                     .encode())

    walk(enc, "enc/")
    walk(dec, "dec/")
    return h.hexdigest()


# computed by the same function on the harness before the decoder's
# layout moved into architectures/qwen3_asr.py
@pytest.mark.parametrize("seed, digest", [
    (1234, "cfd25de5da6140300c3669d6d49717aa34112de3032e7544b3ce4156697398eb"),
    (2 ** 31 + 7,
     "34083761b04eeecd0acd960b7946ccfc2ac406f113aaaee04057850d783a65f8")])
def test_dense_weights_are_the_parents(seed, digest):
    assert weights_digest(*make_weights(tiny_config(), seed, "cpu")) == digest


SECONDS = [2.0, 3.7, 9.25, 14.5, 29.9]
N_TOKENS = [1, 17, 128, 64, 128]


def _calls(seconds: list, n_tokens: list, stats: dict) -> list:
    """One call's ``done`` entry for the batch driver's ``account``."""
    clips = [SimpleNamespace(samples=np.zeros(int(s * 16000), np.float32),
                             seconds=s) for s in seconds]
    st = {"prefill_seconds": 0.5, "decode_gpu_seconds": 0.25,
          "decode_steps": max(n_tokens), "n_gen": list(n_tokens), **stats}
    return [(clips, [[7] * n for n in n_tokens], st)]


# the batch driver's operations and decode bound on the harness before the
# move, for the lengths above, 128 tokens a row at most
@pytest.mark.parametrize("name, flops, bound", [
    ("tiny", 8305807360.0, 0.0007506564202985075),
    ("qwen3-asr-1.7b", 4132890559488.0, 0.13392226273432833)])
def test_dense_accounting_is_the_parents(name, flops, bound):
    cfg = tiny_config() if name == "tiny" else REAL
    prog, got, audio = BATCH.account(
        cfg, _calls(SECONDS, N_TOKENS, {}), 128, BENCH)
    assert got == flops
    assert prog["decode_bound_s"] == bound
    assert audio == pytest.approx(sum(SECONDS))
    assert prog["decode_steps"] == 128


def _toy_config() -> dict:
    cfg = tiny_config()
    cfg.update(name="toy-moe", architecture="toy_moe", reference="toy_moe",
               deployment={"expert_parallel": 4, "num_experts": 16})
    cfg["thinker_config"]["text_config"].update(
        num_hidden_layers=4, layer_types=["linear_attention"] * 3
        + ["full_attention"], linear_conv_kernel_dim=4, num_experts=4,
        num_experts_per_tok=2, moe_intermediate_size=32,
        shared_expert_intermediate_size=48)
    return cfg


def test_new_architecture_is_picked_up_without_edits(tmp_path):
    """A configuration of a routed architecture with two kinds of layer,
    holding 4 of 16 experts, and its reference, mix, check and cell,
    added as files and entries: the harness takes it, and no file that
    was there changes."""
    b, before = copy_bench(tmp_path)
    (b / "architectures" / "toy_moe.py").write_text(
        (BENCH / "tests" / "toy_moe.py").read_text())
    (b / "reference" / "toy_moe.py").write_text(
        "class Reference:\n"
        "    def __init__(self, config, enc, dec, device):\n"
        "        self.config = config\n")
    (b / "configs" / "toy-moe.json").write_text(json.dumps(_toy_config()))
    mix = read_json(b / "traffic" / "batch-b32.json")
    mix["arrival"]["batch"] = 4
    (b / "traffic" / "toy-batch.json").write_text(json.dumps(mix))
    new = "toy-moe-batch"
    (b / "checks" / f"{new}.json").write_text(
        json.dumps({"sample": 4, "limits": {"max_gap": 1.0}}))
    bench = json.loads(json.dumps(with_held(read_json(
        BENCH.parent / "BENCHMARK.json"))))
    bench["configs"].append({
        "name": "toy-moe", "source": "https://example.org/toy-moe",
        "file": "benchmark/configs/toy-moe.json",
        "reduced": ["num_experts"], "why": "routed experts, two layer kinds"})
    bench["workloads"].append({"name": new, "config": "toy-moe",
                               "traffic": "toy-batch", "chips": 1,
                               "why": "a toy"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "asr17-batch-b32" in m.get("workloads", []):
            m["workloads"].append(new)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = load_cell(new, bench_dir=b)
    arch = cell.architecture()
    assert arch.__file__ == str(b / "architectures" / "toy_moe.py")
    assert cell.reference().Reference(cell.config, {}, {}, "cpu")
    assert "decode_step_roofline.offline" in [m["name"]
                                              for m in cell.per_layer]
    cfg = cell.config

    # the toy's leaves, in one draw: every leaf a view of one buffer
    enc, dec = make_weights(cfg, 2 ** 31 + 3, "cpu", b)
    leaves = arch.decoder_leaves(cfg)
    assert "linear_attention" in dec and "full_attention" in dec
    assert dec["moe"]["experts_gate_up_w"].shape == (4, 4, 64, 64)
    assert dec["moe"]["router_w"].shape == (4, 64, 16)
    assert dec["linear_attention"]["in_w"].shape[0] == 3
    assert dec["full_attention"]["q_w"].shape[0] == 1
    store = enc["conv1_w"].untyped_storage().data_ptr()
    for name, (shape, _) in leaves.items():
        node = dec
        for part in name.split("/"):
            node = node[part]
        assert tuple(node.shape) == shape
        assert node.untyped_storage().data_ptr() == store
    assert dec["lm_head"] is dec["embed"]

    # the operations: the encoder's, then the toy's decoder
    frames, _ = work.audio_tokens(cfg, 5 * 16000)
    p = work.prompt_len(cfg, 5 * 16000)
    want = (work.encoder_flops(cfg, frames) + arch.prefill_flops(cfg, p)
            + arch.decode_flops(cfg, p, 9))
    assert work.request_flops(cfg, frames, p, 9, b) == want
    assert want != work.request_flops(tiny_config(), frames, p, 9)

    # the step's bound counts only the experts that the program's
    # counter says each step touched
    secs, toks = [2.0, 3.0], [4, 4]

    def bound(touched):
        prog, _, _ = cell.driver().account(
            cfg, _calls(secs, toks, {"experts_touched": touched}), 4, b)
        return prog["decode_bound_s"]

    one = 2 * arch.expert_weights(cfg) / work.HBM_BYTES_PER_S
    assert bound([3, 5, 2]) - bound([2, 5, 2]) == pytest.approx(one)
    assert bound([16] * 3) - bound([3, 5, 2]) == pytest.approx(
        (48 - 10) * one)
    assert math.isclose(bound([0, 0, 0]), cell.driver().account(
        cfg, _calls(secs, toks, {}), 4, b)[0]["decode_bound_s"])

    assert all(p.read_bytes() == data for p, data in before.items())
