"""Speculative decoding in the port: greedy output equal to plain greedy.

Mirrors every case of ``tests/test_spec_decode.py`` on the port (float32,
the CPU), holding the port's speculative output against the port's plain
greedy loop (which ``test_torch_engine.py`` and ``test_torch_decode_loop.py``
hold against JAX): every draft mode, an adversarial draft, EOS inside the
verify window, the max_new cap, segmented slab growth, the batch and
sampling fallbacks, speculative sampling (top-k 1 equal to greedy,
deterministic, a self-draft accepting everything), cross-model drafts
(quantized, with slab growth, under a quantized target), the draft checks
and the CLI's ``--draft*`` flags against the JAX CLI. Beside them: the
port's ``raw_output`` and ``last_spec_stats`` equal the JAX engine's
(self-draft, int8 draft, cross-model, an int8 target with an int8 KV
slab), ``score_chunk`` equals JAX's at an int and at a device-tensor
``start`` and on an int8 slab, and iterations replayed after the stream
stopped change nothing.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.runtime import engine as engine_mod
from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine
from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    init_encoder_params_np,
)


class _Tok:
    def encode(self, text):
        return [100 + (ord(c) % 50) for c in text]

    def decode(self, ids):
        return " ".join(str(i) for i in ids)


def _cfg(module=tconfig):
    cfg = module.tiny_test_config()
    text = dataclasses.replace(cfg.text, vocab_size=151936)
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, text_config=text))


def _draft_cfg(module=tconfig, vocab=151936, n_window=None):
    """A smaller model than ``_cfg()``: the cross-model draft of the JAX
    tests (one narrower layer, its own audio tower width)."""
    cfg = module.tiny_test_config()
    kw = {} if n_window is None else {"n_window": n_window}
    audio = dataclasses.replace(
        cfg.audio, d_model=32, encoder_layers=1, encoder_attention_heads=2,
        encoder_ffn_dim=64, downsample_hidden_size=16, output_dim=48, **kw)
    text = dataclasses.replace(
        cfg.text, vocab_size=vocab, hidden_size=48, intermediate_size=96,
        num_hidden_layers=1, num_attention_heads=3, num_key_value_heads=1,
        head_dim=16)
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config, audio_config=audio, text_config=text))


def _draft_tuple(dcfg, seed=7):
    return (dcfg, (init_encoder_params_np(dcfg.audio),
                   init_decoder_params_np(dcfg.text, seed=seed)))


# decoder weight scale: the JAX tests' 0.02, whose tiny model repeats
# one token, and VARIED, whose tokens vary and whose quantized drafts are
# accepted only in part
VARIED = 0.1


def _engine(max_new=16, seed_dec=0, scale=0.02, **kw):
    cfg = _cfg()
    return AsrEngine(None, dtype=torch.float32, max_new_tokens=max_new,
                     chunk_buckets=(2, 4), config=cfg,
                     params=(init_encoder_params_np(cfg.audio),
                             init_decoder_params_np(cfg.text, seed=seed_dec,
                                                    scale=scale)),
                     tokenizer=_Tok(), device="cpu", **kw)


def _clip(rng, seconds=2):
    return (rng.standard_normal(16000 * seconds) * 0.1).astype(np.float32)


@pytest.mark.parametrize("spec_mode,k,scale", [
    ("bf16", 4, 0.02),   # self-draft: acceptance 1.0, the machinery alone
    ("int8", 3, 0.02),
    ("int4", 2, 0.02),
    ("int4g", 2, 0.02),
    ("lm8", 1, 0.02),
    ("bf16", 4, VARIED),
    ("int8", 3, VARIED),
    ("int4", 2, VARIED),
])
def test_spec_matches_plain_greedy(rng, spec_mode, k, scale):
    clip = _clip(rng)
    plain = _engine(scale=scale).transcribe_samples(clip)
    eng = _engine(scale=scale, speculative=spec_mode, spec_k=k)
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    st = eng.last_spec_stats
    assert st["iterations"] >= 1 and st["tokens"] <= 16
    assert st["tokens"] == len(plain.raw_output.split())
    if spec_mode == "bf16":  # every draft accepted
        assert eng.last_stats["drafts_accepted"] == k * st["iterations"]
    if scale == VARIED:
        assert len(set(plain.raw_output.split())) > 2
        if spec_mode == "int4":  # a draft that disagrees at times
            assert 0 < st["mean_accepted"] < k


def test_spec_adversarial_draft_still_exact(rng):
    """A draft with the wrong weights changes no token (VARIED weights:
    the drafts are rejected, where the tiny model at 0.02 agrees)."""
    clip = _clip(rng)
    plain = _engine(max_new=12, scale=VARIED).transcribe_samples(clip)
    eng = _engine(max_new=12, scale=VARIED, speculative="bf16", spec_k=4)
    eng.draft_params = _engine(max_new=12, seed_dec=99,
                               scale=VARIED).dec_params
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    st = eng.last_spec_stats
    assert st["tokens"] >= st["iterations"]
    assert st["mean_accepted"] < 1


def test_spec_eos_inside_window(rng, monkeypatch):
    """An EOS inside a verify window stops the output where the
    sequential loop stops."""
    clip = _clip(rng)
    toks = [int(t) for t in
            _engine(max_new=12).transcribe_samples(clip).raw_output.split()]
    assert len(toks) >= 4
    cut = next((i for i in range(1, len(toks)) if toks[i] not in toks[:i]),
               0)
    monkeypatch.setattr(engine_mod, "EOS_TOKEN_IDS",
                        (toks[cut], engine_mod.EOS_TOKEN_IDS[1]))
    plain = _engine(max_new=12).transcribe_samples(clip)
    assert [int(t) for t in plain.raw_output.split()] == toks[:cut]
    spec = _engine(max_new=12, speculative="bf16", spec_k=4)
    assert spec.transcribe_samples(clip).raw_output == plain.raw_output


@pytest.mark.parametrize("cap", [1, 2, 5])
def test_spec_max_new_cap(rng, cap):
    clip = _clip(rng)
    plain = _engine(max_new=cap).transcribe_samples(clip)
    spec = _engine(max_new=cap, speculative="bf16",
                   spec_k=3).transcribe_samples(clip)
    assert spec.raw_output == plain.raw_output
    assert len(spec.raw_output.split()) <= cap


def test_spec_segmented_slab_growth(rng, monkeypatch):
    """Spec equals plain across decode segments: a 2-token first slab
    grows (both slabs) mid-decode."""
    monkeypatch.setenv("ASR_DECODE_SEGMENT", "2")
    clip = _clip(rng)
    plain = _engine(max_new=14, scale=VARIED).transcribe_samples(clip)
    eng = _engine(max_new=14, scale=VARIED, speculative="int8", spec_k=3)
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    assert len(eng.last_stats["slab_lens"]) == 3  # caps [2, 8, 14]


def test_spec_batch_and_sampling_fall_back(rng):
    """Batches take the plain loop; temperature 0 is greedy."""
    clip = _clip(rng)
    eng = _engine(max_new=6, speculative="int8", spec_k=3)
    plain = _engine(max_new=6)
    eng.last_spec_stats = None
    a = eng.transcribe_batch([clip, clip])
    assert eng.last_spec_stats is None  # the plain batched loop ran
    assert ([r.raw_output for r in a]
            == [r.raw_output for r in plain.transcribe_batch([clip, clip])])
    s = eng.transcribe_samples(clip, sampling=SamplingParams(temperature=0.0))
    assert s.raw_output == plain.transcribe_samples(clip).raw_output
    assert eng.last_spec_stats is not None


def test_spec_sampling_topk1_is_bitwise_greedy(rng):
    """Speculative sampling with top_k 1 (one-hot p and q) is greedy, for
    a quantized and a cross-model draft."""
    clip = _clip(rng)
    plain = _engine(max_new=12).transcribe_samples(clip)
    sp = SamplingParams(temperature=0.9, top_k=1, seed=3)
    for kw in (dict(speculative="int8", spec_k=3),
               dict(draft_model=_draft_tuple(_draft_cfg()), spec_k=2)):
        eng = _engine(max_new=12, **kw)
        assert eng.transcribe_samples(clip, sampling=sp).raw_output == (
            plain.raw_output)
        assert eng.last_spec_stats["iterations"] >= 1


def test_spec_sampling_deterministic_and_capped(rng):
    clip = _clip(rng)
    eng = _engine(max_new=9, speculative="int8", spec_k=3)
    sp = SamplingParams(temperature=0.8, seed=11)
    a = eng.transcribe_samples(clip, sampling=sp)
    assert eng.transcribe_samples(clip, sampling=sp).raw_output == a.raw_output
    assert len(a.raw_output.split()) <= 9
    c = eng.transcribe_samples(
        clip, sampling=SamplingParams(temperature=0.8, seed=12))
    assert c.raw_output != a.raw_output


def test_spec_sampling_self_draft_accepts_everything(rng):
    """A self-draft's q equals p: every draft accepted, k + 1 tokens per
    iteration (12 tokens = 4 + 4 + 4 at k = 3, no EOS on these
    weights)."""
    clip = _clip(rng)
    eng = _engine(max_new=12, speculative="bf16", spec_k=3)
    out = eng.transcribe_samples(
        clip, sampling=SamplingParams(temperature=0.7, seed=5))
    st = eng.last_spec_stats
    assert st == {"iterations": 3, "tokens": 12, "mean_accepted": 3.0}
    assert eng.last_stats["drafts_accepted"] == 9
    assert len(out.raw_output.split()) == 12


def test_cross_model_draft_bit_identical(rng):
    """A smaller draft with its own encoder, embeddings, widths and slab
    changes no token."""
    clip = _clip(rng)
    plain = _engine(max_new=14).transcribe_samples(clip)
    eng = _engine(max_new=14, spec_k=3,
                  draft_model=_draft_tuple(_draft_cfg()))
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    st = eng.last_spec_stats
    assert st["iterations"] >= 1 and st["tokens"] >= st["iterations"]


def test_cross_model_draft_quantized(rng):
    """``speculative`` names the draft's quantization with a draft
    model."""
    clip = _clip(rng)
    plain = _engine(max_new=10).transcribe_samples(clip)
    eng = _engine(max_new=10, speculative="int8", spec_k=2,
                  draft_model=_draft_tuple(_draft_cfg()))
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    assert eng.draft_params is None
    assert eng.draft_bundle.dec_params["lm_head_q"].dtype == torch.int8
    assert eng.draft_bundle.dec_params["layers"]["qkv_w_q"].dtype == (
        torch.int8)


def test_cross_model_draft_slab_growth(rng, monkeypatch):
    """Both slabs (different layers and heads) grow across segments in
    step."""
    monkeypatch.setenv("ASR_DECODE_SEGMENT", "2")
    clip = _clip(rng)
    plain = _engine(max_new=12, scale=VARIED).transcribe_samples(clip)
    eng = _engine(max_new=12, scale=VARIED, spec_k=3,
                  draft_model=_draft_tuple(_draft_cfg()))
    assert eng.transcribe_samples(clip).raw_output == plain.raw_output
    assert len(eng.last_stats["slab_lens"]) == 3


def test_cross_model_draft_with_quantized_target(rng):
    """A cross-model draft under an int8 target: the verify runs at the
    target's precision and the output equals the plain int8 engine's."""
    clip = _clip(rng)
    plain_q = _engine(max_new=10, quantize="int8").transcribe_samples(clip)
    spec_q = _engine(max_new=10, quantize="int8", spec_k=2,
                     draft_model=_draft_tuple(_draft_cfg()))
    assert spec_q.transcribe_samples(clip).raw_output == plain_q.raw_output


def test_cross_model_draft_validation():
    with pytest.raises(ValueError, match="vocab_size"):
        _engine(draft_model=_draft_tuple(_draft_cfg(vocab=1024)))
    with pytest.raises(ValueError, match="audio-token layout"):
        _engine(draft_model=_draft_tuple(_draft_cfg(n_window=25)))
    with pytest.raises(ValueError, match="mesh"):
        _engine(draft_model=_draft_tuple(_draft_cfg()), mesh=object())


def test_spec_rejects_mesh():
    with pytest.raises(ValueError, match="mesh"):
        _engine(speculative="int8", mesh=object())
    with pytest.raises(TypeError, match="mesh"):
        _engine(mesh=object())


def test_spec_invalid_modes():
    with pytest.raises(ValueError, match="unknown speculative draft mode"):
        _engine(speculative="fp8")
    with pytest.raises(ValueError, match="spec_k"):
        _engine(speculative="int8", spec_k=0)
    with pytest.raises(ValueError, match="spec_k"):
        _engine(draft_model=_draft_tuple(_draft_cfg()), spec_k=0)


def test_spec_iterations_after_stop_change_nothing(rng):
    """Iterations run after the stream stopped (the replays between two
    reads of the stop flag) leave the tokens, counts and flags as they
    were."""
    clip = _clip(rng)
    eng = _engine(max_new=7, speculative="int8", spec_k=3)
    want = eng.transcribe_samples(clip).raw_output
    # both first-stage arenas stay with the engine (a captured iteration
    # reads them at fixed addresses from call to call)
    arenas = {k: a[0].data_ptr() for k, a in eng._arenas.items()}
    assert set(arenas) == {("spec", "target"), ("spec", "draft")}
    eng.transcribe_samples(clip)
    assert {k: a[0].data_ptr() for k, a in eng._arenas.items()} == arenas
    st = eng._spec_state()
    before = {f.name: getattr(st, f.name).clone()
              for f in dataclasses.fields(st)}
    p = eng._prompt_bucket(eng._chunk_bucket([clip]))
    n = eng._spec_slab_len(p, 7)
    fn = eng._spec_iteration(st, eng._slab0(1, n, ("spec", "target")),
                             eng._slab0(1, n, ("spec", "draft")),
                             SamplingParams())
    with torch.inference_mode():
        for _ in range(3):
            fn()
    for name, t in before.items():
        assert torch.equal(getattr(st, name), t), name
    assert eng.tokenizer.decode(
        st.out_buf[0, :int(st.n_gen[0])].tolist()) == want



def test_batcher_frees_the_speculative_arenas(rng):
    """A batcher built on a speculative engine owns its slab: the
    engine's kept arenas go, the speculative loop's (the target's and
    the draft's) with those of a batch size."""
    from qwen3_asr_rs_tpu_torch.runtime.serving import ContinuousBatcher

    eng = _engine(max_new=7, speculative="int8", spec_k=3)
    clip = _clip(rng)
    eng.transcribe_samples(clip)
    eng.generate_batch([clip, clip], [None, None], np.ones(2, bool))
    assert set(eng._arenas) == {("spec", "target"), ("spec", "draft"), 2}
    ContinuousBatcher(eng, n_slots=1, segment_steps=1)
    assert not eng._arenas and not eng._graphs

# ---- the port against the JAX engine ----------------------------------


def _jax_engine(max_new, scale, **kw):
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine

    cfg = _cfg(jconfig)
    return JaxEngine(
        model_dir=None, dtype=jnp.float32, max_new_tokens=max_new,
        chunk_buckets=(2, 4), config=cfg,
        params=(init_encoder_params(cfg.audio, dtype=jnp.float32),
                init_decoder_params(cfg.text, dtype=jnp.float32,
                                    scale=scale)),
        tokenizer=_Tok(), **kw)


@pytest.mark.parametrize("case", ["bf16", "int8", "cross"])
def test_spec_output_and_stats_match_jax(case):
    """``raw_output`` and ``last_spec_stats`` equal the JAX engine's on
    the same weights and clip (the drafts' weights from the same seeds:
    the numpy initialisers are bit-equal twins of JAX's), at the VARIED
    scale, where the quantized and cross-model drafts are accepted in
    part."""
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params

    kw = {"bf16": dict(speculative="bf16", spec_k=4),
          "int8": dict(speculative="int8", spec_k=3),
          "cross": dict(spec_k=2)}[case]
    jkw, tkw = dict(kw), dict(kw)
    if case == "cross":
        jd = _draft_cfg(jconfig)
        jkw["draft_model"] = (jd, (
            init_encoder_params(jd.audio, dtype=jnp.float32),
            init_decoder_params(jd.text, dtype=jnp.float32, seed=7)))
        tkw["draft_model"] = _draft_tuple(_draft_cfg())
    clip = (np.random.default_rng(4).standard_normal(40000) * 0.1).astype(
        np.float32)
    jeng = _jax_engine(10, VARIED, **jkw)
    teng = _engine(max_new=10, scale=VARIED, **tkw)
    got = teng.transcribe_samples(clip).raw_output
    assert got == jeng.transcribe_samples(clip).raw_output
    assert len(set(got.split())) > 2
    assert teng.last_spec_stats == jeng.last_spec_stats


@pytest.mark.parametrize("tensor_start", [False, True])
def test_score_chunk_matches_jax(tensor_start):
    """``score_chunk`` (argmax and float32 logits) and the slab it writes
    equal JAX's at a start given as an int and as a 0-d tensor, over a
    slab holding a prompt prefill."""
    from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
    from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu_torch.models.text_decoder import (
        KVCache,
        TextDecoder,
    )
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    jcfg, tcfg = _cfg(jconfig).text, _cfg().text
    jp = init_decoder_params(jcfg, dtype=jnp.float32)
    tp = to_torch(jp, torch.float32, "cpu")
    jdec, tdec = JDecoder(jcfg, max_position=64), TextDecoder(tcfg, 64)
    g = np.random.default_rng(2)
    prompt = g.integers(0, 151936, (1, 11)).astype(np.int32)
    block = g.integers(0, 151936, (1, 5)).astype(np.int32)
    start = 11
    jc = JCache.zeros(jcfg, 1, 32, dtype=jnp.float32)
    _, jc = jdec.prefill(jp, jdec.embed(jp, jnp.asarray(prompt)),
                         jnp.arange(11), jc, jnp.int32(11))
    tc = KVCache.zeros(tcfg, 1, 32, dtype=torch.float32)
    tdec.prefill(tp, tdec.embed(tp, torch.from_numpy(prompt).long()),
                 torch.arange(11), tc, 11)
    at = torch.tensor(start) if tensor_start else start
    jlog, jc2 = jdec.score_chunk(jp, jnp.asarray(block), jnp.int32(start),
                                 jc, return_logits=True)
    tc2 = KVCache(tc.k.clone(), tc.v.clone())
    tlog, _ = tdec.score_chunk(tp, torch.from_numpy(block).long(), at, tc2,
                               return_logits=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tc2.k.numpy(), np.asarray(jc2.k), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tc2.v.numpy(), np.asarray(jc2.v), atol=1e-5,
                               rtol=1e-5)
    jtok, _ = jdec.score_chunk(jp, jnp.asarray(block), jnp.int32(start), jc)
    ttok, _ = tdec.score_chunk(tp, torch.from_numpy(block).long(), at, tc)
    assert ttok.dtype == torch.int32
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))


# ---- the CLI ----------------------------------------------------------


def test_cli_draft_flag(tmp_path, capsys, monkeypatch):
    """``--draft``/``--draft-model``/``--draft-k``: the plain invocation's
    stdout, the JAX CLI's stdout and errors."""
    from test_audio_io import write_wav_pcm16
    from test_weights_roundtrip import write_word_tokenizer

    from qwen3_asr_rs_tpu.cli import main as jax_main
    from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
    from qwen3_asr_rs_tpu.weights.export import save_checkpoint
    from qwen3_asr_rs_tpu_torch.cli import main

    cfg, dcfg = _cfg(jconfig), _draft_cfg(jconfig)
    model, draft = tmp_path / "model", tmp_path / "draft"
    save_checkpoint(model, init_encoder_params(cfg.audio, dtype=jnp.float32),
                    init_decoder_params(cfg.text, dtype=jnp.float32), cfg)
    write_word_tokenizer(model)
    save_checkpoint(draft, init_encoder_params(dcfg.audio, dtype=jnp.float32),
                    init_decoder_params(dcfg.text, dtype=jnp.float32, seed=7),
                    dcfg)
    wav = tmp_path / "a.wav"
    write_wav_pcm16(wav, np.random.default_rng(3).standard_normal(32000) * 0.1,
                    16000)
    monkeypatch.setenv("ASR_MAX_NEW_TOKENS", "4")
    monkeypatch.setenv("ASR_DTYPE", "float32")
    monkeypatch.setenv("ASR_DEVICE", "cpu")

    def run(fn, *extra):
        rc = fn([str(model), str(wav), *map(str, extra)])
        out, err = capsys.readouterr()
        return rc, out, err

    rc, plain, _ = run(main)
    assert rc == 0 and plain.startswith("Language: ")
    assert run(jax_main, "--draft", "int8")[:2] == (0, plain)
    for extra in (("--draft", "int8", "--draft-k", "3"),
                  ("--draft-model", draft, "--draft-k", "2"),
                  ("--draft-model", draft, "--draft=int8")):
        rc, out, _ = run(main, *extra)
        assert (rc, out) == (0, plain), extra
    for extra, msg in ((("--draft", "fp8"), "unknown --draft mode"),
                       (("--draft-model", tmp_path / "nope"),
                        "draft model directory not found"),
                       (("--draft-k", "x"), "bad --draft-k value")):
        rc, out, err = run(main, *extra)
        jrc, jout, jerr = run(jax_main, *extra)
        assert (rc, out) == (jrc, jout) == (1, "") and msg in err
        assert err.splitlines()[-1] == jerr.splitlines()[-1]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_score_chunk_equals_sequential_decode_steps(kv):
    """On a float slab the verify's logits at every block position equal
    those of decode steps fed the same tokens one by one, and both leave
    the same slab behind. On an int8 slab every position attends the
    block's K/V as stored (quantized), its own included, as JAX's verify
    does: the logits and the slab equal JAX's ``score_chunk`` on the same
    inputs (float32 within 1e-5)."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import (
        KVCache,
        TextDecoder,
    )
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    cfg = _cfg().text
    params = to_torch(init_decoder_params_np(cfg, scale=VARIED),
                      torch.float32, "cpu")
    dec = TextDecoder(cfg, 64)
    g = np.random.default_rng(5)
    prompt = torch.from_numpy(g.integers(0, 151936, (1, 9)))
    block = torch.from_numpy(g.integers(0, 151936, (1, 5)))
    caches = []
    for _ in range(2):
        c = KVCache.zeros(cfg, 1, 24, dtype=torch.float32,
                          quantized=kv == "int8")
        dec.prefill(params, dec.embed(params, prompt), torch.arange(9), c, 9)
        caches.append(c)
    got, _ = dec.score_chunk(params, block, torch.tensor(9), caches[0],
                             return_logits=True)
    if kv == "int8":
        want, slab = _jax_int8_verify(prompt.numpy(), block.numpy())
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
        for name, a in caches[0].__dict__.items():
            np.testing.assert_allclose(a.numpy(), slab[name], atol=1e-5)
        return
    want = torch.stack([dec.decode_step(params, block[:, i], 9 + i,
                                        caches[1])[0]
                        for i in range(5)], 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
    for a, b in zip(caches[0].__dict__.values(), caches[1].__dict__.values()):
        if a is not None:
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def _jax_int8_verify(prompt, block, steps=False):
    """JAX's ``score_chunk`` logits (1, P, V) over an int8 slab that holds
    the prompt's prefill, and the slab it leaves (as numpy, by field);
    with ``steps`` also JAX's decode steps' logits fed the block one
    token at a time."""
    from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
    from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
    from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params

    cfg = _cfg(jconfig).text
    params = init_decoder_params(cfg, dtype=jnp.float32, scale=VARIED)
    dec = JDecoder(cfg, max_position=64)
    p_len = prompt.shape[1]
    prompt, block = jnp.asarray(prompt, jnp.int32), jnp.asarray(block,
                                                                 jnp.int32)
    cache = JCache.zeros(cfg, 1, 24, dtype=jnp.float32, quantized=True)
    _, cache = dec.prefill(params, dec.embed(params, prompt),
                           jnp.arange(p_len), cache, jnp.int32(p_len))
    got, slab = dec.score_chunk(params, block, jnp.int32(p_len), cache,
                                return_logits=True)
    got = np.asarray(got)
    slab = {f: np.asarray(getattr(slab, f))
            for f in ("k", "v", "k_scale", "v_scale")}
    if not steps:
        return got, slab
    want, c = [], cache
    for i in range(block.shape[1]):
        logits, c = dec.decode_step(params, block[:, i],
                                    jnp.int32(p_len + i), c)
        want.append(np.asarray(logits))
    return got, np.stack(want, 1)


def test_spec_with_int8_kv_matches_plain_greedy(rng):
    """Speculative output with an int8 KV slab (int8 target, int8 draft)
    equals the JAX engine's speculative output, tokens and stats, on the
    same weights and clip: the verify attends its block's K/V as stored,
    as JAX's does. (Where int8 rounding reorders the two best logits,
    both may leave their plain greedy output.)"""
    clip = _clip(rng)
    kw = dict(quantize="int8", kv_dtype="int8", speculative="int8",
              spec_k=4)
    spec = _engine(scale=VARIED, **kw)
    jeng = _jax_engine(16, VARIED, **kw)
    want = jeng.transcribe_samples(clip).raw_output
    assert spec.transcribe_samples(clip).raw_output == want
    assert spec.last_spec_stats == jeng.last_spec_stats
    assert len(set(want.split())) > 2


def test_jax_verify_on_int8_slab_leaves_its_decode_steps():
    """A defect of the JAX package that the port copies: on an int8 slab
    JAX's ``score_chunk`` attends each position's own K/V as stored
    (quantized), so its logits leave those of decode steps fed the same
    tokens (which attend their own K/V unquantized) by far more than
    float32 rounding; the port's verify and decode steps leave each other
    the same way."""
    from qwen3_asr_rs_tpu_torch.models.text_decoder import (
        KVCache,
        TextDecoder,
    )
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    g = np.random.default_rng(5)
    prompt = g.integers(0, 151936, (1, 9))
    block = g.integers(0, 151936, (1, 5))
    jgot, jwant = _jax_int8_verify(prompt, block, steps=True)
    assert np.abs(jgot[0] - jwant[0]).max() > 1e-3
    cfg = _cfg().text
    params = to_torch(init_decoder_params_np(cfg, scale=VARIED),
                      torch.float32, "cpu")
    dec = TextDecoder(cfg, 64)
    c = KVCache.zeros(cfg, 1, 24, dtype=torch.float32, quantized=True)
    dec.prefill(params, dec.embed(params, torch.from_numpy(prompt)),
                torch.arange(9), c, 9)
    want = [dec.decode_step(params, torch.from_numpy(block[:, i]), 9 + i,
                            c)[0].numpy() for i in range(5)]
    np.testing.assert_allclose(np.stack(want, 1), jwant, atol=1e-5,
                               rtol=1e-5)
