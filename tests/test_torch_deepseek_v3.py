"""The port's ``deepseek_v3`` decoder (Kimi-VL-A3B's language model under
the Qwen3-ASR audio tower) against the plain float32 reference
``tests/torch_ref_deepseek_v3.py``, on the CPU at a tiny size: 3 layers
(one dense), 8 routed experts of which 2 a token, 1 shared, latent and
rope widths cut down, float32 weights drawn by the benchmark's
``architectures/deepseek_v3.py`` layout.

Tolerances. Everything here is float32 on the CPU: the port and the
reference differ only in the order of their float32 sums (SDPA against
an explicit softmax, the absorbed decode against the expanded form, the
routed sum per route against a per-expert ``index_add``), a few units of
1e-6 relative on logits of magnitude ~1; 1e-4 absolute leaves a margin
of ~10x and is far below the gap a flipped route or a wrong term makes
(~1e-1 at these weights, the fault tests below). The routes are compared
exactly: a near-tie within float32's rounding of a router score would
flip one, and none does at these seeds.

The ``cuda`` test holds K7 to its plain version at the published widths
on a card (skipped elsewhere; it imports no JAX, so it also runs with
``--noconftest``).
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import copy
import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_ref_deepseek_v3 as ref

from qwen3_asr_rs_tpu_torch.config import (
    AsrConfig,
    DeepseekV3TextConfig,
    TextDecoderConfig,
)
from qwen3_asr_rs_tpu_torch.models.deepseek_v3_decoder import (
    ArchitectureNotSupported,
    DeepseekV3Decoder,
    LatentCache,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.fused_elementwise import (
    latent_rope,
    latent_rope_plain,
    rms_norm,
)
from qwen3_asr_rs_tpu_torch.ops.kernels.moe_experts import (
    align,
    align_plain,
    moe_experts,
    moe_experts_plain,
    route,
    route_plain,
)
from qwen3_asr_rs_tpu_torch.ops.norms import rms_norm as rms_norm_plain
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[1]
BENCH = ROOT / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from harness.weights import make_weights  # noqa: E402

ATOL = 1e-4
CONFIG = json.loads((BENCH / "configs" / "kimi-vl-a3b-asr.json").read_text())
SEED = 2 ** 31 + 19
# clips of 1.0, 1.9 and 1.25 s in one 4-chunk bucket: three prompt
# lengths, and a born-done fourth row when they pad to B = 4
CLIPS = [(np.random.default_rng(i).standard_normal(n) * 0.1).astype(np.float32)
         for i, n in enumerate((16000, 30000, 20000))]


class _Tok:
    def encode(self, s):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def tiny_config() -> dict:
    """The benchmark's configuration at a tiny size, in float32."""
    cfg = copy.deepcopy(CONFIG)
    cfg["dtype"] = "float32"
    cfg["weight_init"] = {"scale": 0.3}
    cfg["thinker_config"]["audio_config"].update(
        d_model=64, encoder_layers=2, encoder_attention_heads=4,
        encoder_ffn_dim=128, downsample_hidden_size=32, output_dim=64)
    cfg.update(
        vocab_size=151936, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=32, num_hidden_layers=3,
        num_attention_heads=4, num_key_value_heads=4, n_shared_experts=1,
        n_routed_experts=8, num_experts_per_tok=2, kv_lora_rank=32,
        qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16)
    return cfg


def _text(cfg) -> dict:
    """The decoder's keys of a configuration file: the top level, with
    ``thinker_config.text_config`` over it (``AsrConfig.from_dict``'s
    rule for a ``deepseek_v3`` decoder)."""
    top = {k: v for k, v in cfg.items() if k != "thinker_config"}
    return {**top, **cfg["thinker_config"]["text_config"]}


def _weights(cfg, seed=SEED):
    return make_weights(cfg, seed, "cpu", BENCH)


def _engine(cfg, weights, max_new=6, **kw):
    return AsrEngine(None, config=AsrConfig.from_dict(cfg), params=weights,
                     tokenizer=_Tok(), device="cpu", dtype=torch.float32,
                     max_new_tokens=max_new, chunk_buckets=(4,), **kw)


class _Recorder:
    """Records the decoder's prefill input and the logits of the prefill
    and of every decode step, through the engine's own calls."""

    def __init__(self, monkeypatch):
        self.steps = []
        pre, step = (DeepseekV3Decoder.prefill_aligned,
                     DeepseekV3Decoder.decode_step_aligned)

        def prefill_aligned(dec, params, hidden, kv_start, cache, **kw):
            self.hidden, self.kv_start = hidden.clone(), kv_start.clone()
            logits, cache = pre(dec, params, hidden, kv_start, cache, **kw)
            self.prefill = logits.clone()
            return logits, cache

        def decode_step_aligned(dec, *a, **kw):
            logits, cache = step(dec, *a, **kw)
            self.steps.append(logits.clone())
            return logits, cache

        monkeypatch.setattr(DeepseekV3Decoder, "prefill_aligned",
                            prefill_aligned)
        monkeypatch.setattr(DeepseekV3Decoder, "decode_step_aligned",
                            decode_step_aligned)


def _reference_rows(cfg, dec, rec, tokens):
    """Per real row: (reference logits at the prompt's last position and
    after each served token, the reference's routes per MoE layer)."""
    t = _text(cfg)
    out = []
    for b, toks in enumerate(tokens):
        start = int(rec.kv_start[b])
        emb = torch.cat([rec.hidden[b, start:],
                         dec["embed"][torch.tensor(toks, dtype=torch.long)]])
        logits, routes = ref.forward(t, dec, emb, torch.arange(len(emb)))
        n_prompt = rec.hidden.shape[1] - start
        out.append((logits[n_prompt - 1:], [r[n_prompt - 1:]
                                            for r in routes]))
    return out


@pytest.fixture(scope="module")
def tiny():
    cfg = tiny_config()
    return cfg, _weights(cfg)


def test_engine_prefill_and_decode_match_the_reference(tiny, monkeypatch):
    """transcribe_batch (right-aligned prompts, a born-done pad row, the
    latent cache, the absorbed decode) against the reference's full
    forward over each row's prompt and served tokens, on logits at the
    prefill and at every decode step the row was live."""
    cfg, (enc, dec) = tiny
    eng = _engine(cfg, (enc, dec))
    rec = _Recorder(monkeypatch)
    out = eng.transcribe_batch(CLIPS)
    tokens = [[int(x) for x in r.raw_output.split()] for r in out]
    assert [len(t) for t in tokens] == eng.last_stats["n_gen"][:3]
    assert len(rec.steps) == eng.last_stats["decode_steps"] == 5
    for b, (logits, _) in enumerate(_reference_rows(cfg, dec, rec, tokens)):
        torch.testing.assert_close(rec.prefill[b], logits[0], atol=ATOL,
                                   rtol=0)
        for s in range(len(tokens[b]) - 1):
            torch.testing.assert_close(rec.steps[s][b], logits[s + 1],
                                       atol=ATOL, rtol=0)


def test_absorbed_decode_matches_the_expanded_prefill(tiny):
    """On one cache: the prefill of S + 1 tokens (expanded MLA) and the
    prefill of S followed by one decode step (absorbed MLA over the
    latent slab) give the same last logits and the same latents."""
    cfg, (_, dec) = tiny
    text = AsrConfig.from_dict(cfg).text
    d = DeepseekV3Decoder(text, max_position=64)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, text.vocab_size, (2, 12), generator=g)
    hidden = d.embed(dec, ids)
    full = LatentCache.zeros(text, 2, 16, dtype=torch.float32)
    want, _ = d.prefill(dec, hidden, torch.arange(12), full, 12)
    part = LatentCache.zeros(text, 2, 16, dtype=torch.float32)
    d.prefill(dec, hidden[:, :11], torch.arange(11), part, 11)
    got, _ = d.decode_step(dec, ids[:, 11], torch.tensor(11), part)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)
    torch.testing.assert_close(part.c[:, :, :12], full.c[:, :, :12],
                               atol=1e-5, rtol=0)


def test_bf16_decoder_keeps_its_residual_stream_in_float32(tiny,
                                                         monkeypatch):
    """With bf16 weights every norm of the prefill and of a decode step
    reads the float32 residual stream and hands the layer bf16, and the
    cache holds bf16 latents: the residual is not rounded between
    layers (the published bf16 model rounds it)."""
    from qwen3_asr_rs_tpu_torch.models import deepseek_v3_decoder as dv3

    cfg, (_, dec) = tiny
    dec16 = {k: ({kk: vv.bfloat16() for kk, vv in v.items()}
                 if isinstance(v, dict) else v.bfloat16())
             for k, v in dec.items()}
    text = AsrConfig.from_dict(cfg).text
    d = DeepseekV3Decoder(text, max_position=64)
    seen = []
    norm = dv3.rms_norm

    def rec(x, w, eps, out_dtype=None):
        y = norm(x, w, eps, out_dtype)
        seen.append((x.dtype, y.dtype))
        return y

    monkeypatch.setattr(dv3, "rms_norm", rec)
    ids = torch.randint(0, text.vocab_size, (2, 6),
                        generator=torch.Generator().manual_seed(4))
    cache = LatentCache.zeros(text, 2, 8, dtype=torch.bfloat16)
    d.prefill(dec16, d.embed(dec16, ids), torch.arange(6), cache, 6)
    d.decode_step(dec16, ids[:, 0], torch.tensor(6), cache)
    per_forward = 2 * text.num_hidden_layers + 1
    assert seen == [(torch.float32, torch.bfloat16)] * (2 * per_forward)
    assert cache.c.dtype == torch.bfloat16


def test_route_counters_match_the_reference_routing(tiny, monkeypatch):
    """``last_stats["experts_touched"]`` and the tracer's ``moe.*``
    counters against a direct count of the reference's routes: per decode
    step the experts with at least one live row, summed over the MoE
    layers; the prefill's over every row's real prompt positions."""
    cfg, (enc, dec) = tiny
    registry = tracing.Timings()
    monkeypatch.setattr(tracing, "GLOBAL_TIMINGS", registry)
    monkeypatch.setattr(tracing, "_enabled", True)
    eng = _engine(cfg, (enc, dec))
    rec = _Recorder(monkeypatch)
    out = eng.transcribe_batch(CLIPS)
    tokens = [[int(x) for x in r.raw_output.split()] for r in out]
    rows = _reference_rows(cfg, dec, rec, tokens)
    n_gen = eng.last_stats["n_gen"]
    steps = eng.last_stats["decode_steps"]
    touched, decode_rows, most = [], 0, 0
    for s in range(steps):
        n = 0
        live = [r for b, (_, r) in enumerate(rows) if s < n_gen[b]]
        for layer in range(len(rows[0][1])):
            ids = [r[layer][s + 1] for r in live]
            if ids:
                counts = torch.bincount(torch.cat(ids), minlength=8)
                n += int((counts > 0).sum())
                decode_rows += int(counts.sum())
                most = max(most, int(counts.max()))
        touched.append(n)
    assert eng.last_stats["experts_touched"] == touched
    # the prefill routes every row's real prompt, the pad row's too (a
    # copy of the last clip's)
    text = _text(cfg)
    prompts = []
    for b in range(4):
        emb = rec.hidden[b, int(rec.kv_start[b]):]
        prompts.append(ref.forward(text, dec, emb,
                                   torch.arange(len(emb)))[1])
    pf_touched = pf_rows = 0
    for layer in range(len(prompts[0])):
        counts = torch.bincount(torch.cat([r[layer].reshape(-1)
                                           for r in prompts]), minlength=8)
        pf_touched += int((counts > 0).sum())
        pf_rows += int(counts.sum())
        most = max(most, int(counts.max()))
    c = registry.counters
    assert c["moe.decode_experts_touched"] == sum(touched)
    assert c["moe.decode_rows"] == decode_rows
    assert c["moe.prefill_experts_touched"] == pf_touched
    assert c["moe.prefill_rows"] == pf_rows
    assert c["moe.max_expert_rows"] == most


def test_benchmark_reference_matches_the_tests_reference(tiny):
    """The benchmark's copy (its own audio path, per-product upcasts)
    and this reference give the same logits on the same weights."""
    cfg, (enc, dec) = tiny
    spec = importlib.util.spec_from_file_location(
        "bench_kimi_vl_asr", BENCH / "reference" / "kimi_vl_asr.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    bref = mod.Reference(cfg, enc, dec, "cpu")
    toks = [151643 - 7, 42, 9000]
    got = bref.continuation_logits(CLIPS[1], toks)
    audio = bref.encode(bref.log_mel(CLIPS[1]))
    ids = bref.prompt(audio.shape[0]) + toks
    h = dec["embed"][torch.tensor(ids)].float()
    h[9: 9 + audio.shape[0]] = audio
    want, _ = ref.forward(_text(cfg), dec, h,
                          torch.arange(len(ids)))
    torch.testing.assert_close(got, want[len(ids) - len(toks) - 1:],
                               atol=ATOL, rtol=0)


def test_moe_experts_and_grouping_match_a_loop():
    """The routed experts (the plain path) against a loop over tokens,
    and ``align``'s grouping: each expert's routes in one run of whole
    blocks, dead routes (rows not live) nowhere."""
    g = torch.Generator().manual_seed(5)
    t, h, inter, e, k = 11, 16, 8, 6, 2
    x = torch.randn(t, h, generator=g)
    gu = torch.randn(e, h, 2 * inter, generator=g) * 0.3
    dn = torch.randn(e, inter, h, generator=g) * 0.3
    rw = torch.randn(h, e, generator=g)
    live = torch.arange(t) % 4 != 3
    routes = route(x, rw, torch.zeros(e), k, 2.0, True, live)
    ids, w, counts = routes.ids, routes.weights, routes.counts
    assert (ids[~live] == e).all() and (w[~live] == 0).all()
    torch.testing.assert_close(w[live].sum(-1), torch.full((int(live.sum()),),
                                                           2.0))
    y = moe_experts(x, routes, gu, dn)
    want = torch.zeros(t, h)
    for i in range(t):
        for j in range(k):
            if ids[i, j] < e:
                a = x[i] @ gu[ids[i, j]]
                act = torch.nn.functional.silu(a[:inter]) * a[inter:]
                want[i] += w[i, j] * (act @ dn[ids[i, j]])
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    assert counts.tolist() == [int((ids == j).sum()) for j in range(e)]
    sorted_ids, block_e = align(routes, 4)
    n = ids.numel()
    flat = ids.reshape(-1)
    seen = []
    for blk, ex in enumerate(block_e.tolist()):
        routes = [r for r in sorted_ids[blk * 4:(blk + 1) * 4].tolist()
                  if r < n]
        if ex == e:
            assert not routes
            continue
        assert all(int(flat[r]) == ex for r in routes)
        seen += routes
    assert sorted(seen) == sorted(i for i in range(n) if flat[i] < e)


def test_config_keeps_the_published_keys():
    """The benchmark's file reads as the deepseek_v3 config with every
    published key at its value: the keys stand once, at the file's top
    level (the catalog's form), and ``thinker_config.text_config`` names
    the model type alone."""
    text = AsrConfig.from_dict(CONFIG).text
    assert isinstance(text, DeepseekV3TextConfig)
    assert CONFIG["thinker_config"]["text_config"] == {
        "model_type": "deepseek_v3"}
    names = {f.name for f in dataclasses.fields(text)} - {"model_type"}
    assert len(names & set(CONFIG)) >= 25
    for name in names & set(CONFIG):
        assert getattr(text, name) == CONFIG[name], name
    assert (text.latent_dim, text.qk_head_dim, text.n_moe_layers) == (
        576, 192, 26)


@pytest.mark.parametrize("model_type", ["qwen3_moe", "llama", "deepseek_v2"])
def test_unknown_model_type_raises(model_type):
    """A text config of an architecture the port does not compute is
    refused rather than read as the dense decoder."""
    d = {"thinker_config": {"text_config": {"model_type": model_type,
                                            "hidden_size": 64}}}
    with pytest.raises(ValueError, match="model_type"):
        AsrConfig.from_dict(d)
    assert isinstance(AsrConfig.from_dict({}).text, TextDecoderConfig)
    assert isinstance(AsrConfig.from_dict(
        {"thinker_config": {"text_config": {"model_type": "qwen3"}}}).text,
        TextDecoderConfig)


def _refusals():
    from qwen3_asr_rs_tpu_torch.runtime.serving import ContinuousBatcher
    from qwen3_asr_rs_tpu_torch.runtime.streaming import (
        StreamingSession,
        StreamingTranscriber,
    )
    from qwen3_asr_rs_tpu_torch.training.train_step import make_train_step
    from qwen3_asr_rs_tpu_torch.weights.export import save_checkpoint
    from qwen3_asr_rs_tpu_torch.weights.loader import load_model_params

    def engine(**kw):
        cfg = tiny_config()
        return lambda w: _engine(cfg, w, **kw)

    def with_engine(fn):
        return lambda w: fn(_engine(tiny_config(), w))

    return {
        "serving": with_engine(ContinuousBatcher),
        "streaming": with_engine(StreamingSession),
        "streaming_transcriber": with_engine(StreamingTranscriber),
        "speculative": engine(speculative="bf16"),
        "training": lambda w: make_train_step(
            AsrConfig.from_dict(tiny_config()), None, device="cpu"),
        "tp": lambda w: DeepseekV3Decoder(
            AsrConfig.from_dict(tiny_config()).text, tp=object()),
        "quantized": engine(quantize="int8"),
        "int8_cache": engine(kv_dtype="int8"),
        "checkpoint_loading": lambda w: load_model_params(
            ROOT, AsrConfig.from_dict(tiny_config())),
        "checkpoint_export": lambda w: save_checkpoint(
            ROOT / "build" / "never", *w, AsrConfig.from_dict(tiny_config())),
    }


@pytest.mark.parametrize("mode", sorted(_refusals()))
def test_modes_out_of_scope_refuse_the_architecture(tiny, mode):
    with pytest.raises(ArchitectureNotSupported, match="deepseek_v3"):
        _refusals()[mode](tiny[1])


# ------------------------------------------------------------------ card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (K7 is a Triton kernel)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("tokens", [64, 4096])
def test_cuda_moe_experts_match_plain_at_published_widths(cuda, tokens):
    """K7 against its plain versions at Kimi-VL-A3B's expert widths (H
    2048, I 1408, 64 experts, top-6), a decode step's 64 rows and a
    prefill's 4096 (blocks of 16 and 64), a quarter of the rows dead.
    The routing: the same experts and, to float32 rounding, the same
    weights (the kernel's sigmoid against torch's: 1e-6), every live
    route placed once in its expert's run. The outputs: both round the
    activation to bf16 and sum in float32, in another order: 2e-2 on
    outputs of ~1 is a few bf16 units."""
    g = torch.Generator(device=cuda).manual_seed(7)
    h, inter, e, k = 2048, 1408, 64, 6
    x = torch.randn(tokens, h, generator=g, device=cuda).bfloat16()
    gu = (torch.randn(e, h, 2 * inter, generator=g, device=cuda)
          * 0.02).bfloat16()
    dn = (torch.randn(e, inter, h, generator=g, device=cuda)
          * 0.02).bfloat16()
    rw = (torch.randn(h, e, generator=g, device=cuda) * 0.02).bfloat16()
    bias = (torch.randn(e, generator=g, device=cuda) * 0.02).bfloat16()
    live = torch.arange(tokens, device=cuda) % 4 != 1
    n = moe_experts.launches
    routes = route(x, rw, bias, k, 2.446, True, live)
    want_routes = route_plain(x, rw, bias, k, 2.446, True, live)
    order = routes.ids.argsort(-1)
    w_order = want_routes.ids.argsort(-1)
    assert (routes.ids.gather(1, order)
            == want_routes.ids.gather(1, w_order)).all()
    torch.testing.assert_close(routes.weights.gather(1, order),
                               want_routes.weights.gather(1, w_order),
                               atol=1e-6, rtol=0)
    assert (routes.counts.long() == want_routes.counts).all()
    sorted_ids, block_e = align(routes, 16)
    want_sorted, want_block = align_plain(routes, 16)
    assert (block_e == want_block).all()
    assert (sorted_ids == want_sorted).all()
    got = moe_experts(x, routes, gu, dn)
    assert moe_experts.launches == n + 5
    want = moe_experts_plain(x, routes, gu, dn)
    assert (got.float() - want.float()).abs().max() <= 2e-2
    assert int(routes.counts.sum()) == int(live.sum()) * k
    assert (got[~live] == 0).all()


@pytest.mark.cuda
def test_cuda_fused_elementwise_match_plain(cuda):
    """K8's RMSNorm and latent prologue against their plain versions at
    the published widths, 64 x 432 rows: both compute in float32 and round
    once to bf16, their sums in another order: one bf16 unit (2^-8
    relative) on values of ~1, 2e-2."""
    g = torch.Generator(device=cuda).manual_seed(9)
    rows, h, nh, r, d = 64 * 432, 2048, 16, 512, 64
    x = torch.randn(rows, h, generator=g, device=cuda).bfloat16()
    w = (1 + 0.02 * torch.randn(h, generator=g, device=cuda)).bfloat16()
    n = rms_norm.launches
    got = rms_norm(x, w, 1e-5)
    assert rms_norm.launches == n + 1
    assert (got.float() - rms_norm_plain(x, w, 1e-5).float()).abs().max() \
        <= 2e-2
    q = torch.randn(64, 432, nh, 192, generator=g, device=cuda).bfloat16()
    ckv = torch.randn(64, 432, r + d, generator=g, device=cuda).bfloat16()
    ang = torch.rand(64, 432, d // 2, generator=g, device=cuda) * 6.28
    cos = torch.cat([ang.cos(), ang.cos()], -1)
    sin = torch.cat([ang.sin(), ang.sin()], -1)
    lw = w[:r].contiguous()
    got = latent_rope(q, ckv, cos, sin, lw, 1e-6, 128)
    want = latent_rope_plain(q, ckv, cos, sin, lw, 1e-6, 128)
    for a, b in zip(got, want):
        assert a.shape == b.shape
        assert (a.float() - b.float()).abs().max() <= 2e-2
