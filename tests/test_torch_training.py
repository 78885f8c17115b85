"""Fine-tuning in the port against the JAX package (CPU, float32).

The port's ``asr_loss`` and every gradient leaf (``embed`` and the tied
``lm_head`` apart: JAX gives the two leaves their own cotangents) match
``jax.value_and_grad(asr_loss)``; one SGD step and two AdamW steps (the
second exercises the bias correction) leave parameters equal to optax's;
remat equals no remat; the loss falls over 8 steps. ``forward_full``
matches JAX's on float, int8 and int4 trees, and raises instead of
detaching when a gradient would have to pass K3, K4 or K5.

Tolerances (float32, the two sides add the same products in other
orders): the loss rel 1e-5; each gradient leaf within 1e-5 of that
leaf's largest JAX magnitude plus 1e-9 (a bias whose exact gradient is
zero, like the encoder's k_b, carries noise of ~1e-12); parameters after
an update atol 1e-6 / rtol 1e-5 (an update is lr = 1e-3 in size);
logits atol/rtol 1e-5.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import AudioEncoder as JEncoder
from qwen3_asr_rs_tpu.models.audio_encoder import init_encoder_params
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.models.text_decoder import init_decoder_params
from qwen3_asr_rs_tpu.training import train_step as jts
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch.models.audio_encoder import AudioEncoder
from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.training import train_step as tts
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant
from qwen3_asr_rs_tpu_torch.weights.convert import (
    from_torch,
    to_torch,
    train_state_from_numpy,
)

from test_training import make_batch

LR = 1e-3
P_TOL = dict(atol=1e-6, rtol=1e-5)
LOGIT_TOL = dict(atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX params, numpy params, numpy batch)."""
    jcfg, tcfg = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    jparams = {
        "encoder": init_encoder_params(jcfg.audio, dtype=jnp.float32),
        "decoder": init_decoder_params(jcfg.text, dtype=jnp.float32),
    }
    np_params = jax.tree_util.tree_map(np.asarray, jparams)
    batch = make_batch(jcfg, 2, np.random.default_rng(0))
    return jcfg, tcfg, jparams, np_params, batch


@pytest.fixture(scope="module")
def jax_value_and_grad(setup):
    jcfg, *_, batch = setup
    enc, dec = JEncoder(jcfg.audio), JDecoder(jcfg.text, max_position=256)
    return jax.jit(jax.value_and_grad(
        lambda p: jts.asr_loss(jcfg, enc, dec, p, batch, remat=False)))


@pytest.fixture(scope="module")
def jax_grads(setup, jax_value_and_grad):
    loss, grads = jax_value_and_grad(setup[2])
    return float(loss), jax.tree_util.tree_map(np.asarray, grads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _jax_steps(setup, value_and_grad, optimizer, n):
    """[(loss, params, grads)] of n steps of JAX's train step body
    (``value_and_grad``, ``optimizer.update``, ``apply_updates``),
    numpy."""
    params = setup[2]
    opt_state = optimizer.init(params)
    out = []
    for _ in range(n):
        loss, grads = value_and_grad(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        out.append((float(loss), *(jax.tree_util.tree_map(np.asarray, t)
                                   for t in (params, grads))))
    return out


def _port_steps(setup, optimizer, n, remat=True):
    _, tcfg, _, np_params, batch = setup
    state = train_state_from_numpy(np_params, optimizer, device="cpu")
    step = tts.make_train_step(tcfg, optimizer, max_position=256,
                               remat=remat, device="cpu")
    out = []
    for _ in range(n):
        state, loss = step(state, batch)
        out.append((float(loss), from_torch(state.params)))
    return state, out


def _assert_params(got, want, slack=None):
    """``slack``: {leaf: per-element extra atol} (see the AdamW test)."""
    got, want = _flat(got), _flat(want)
    assert got.keys() == want.keys()
    for name in want:
        g, w = got[name], want[name]
        extra = 0.0 if slack is None else slack[name]
        bad = np.abs(g - w) > P_TOL["atol"] + extra + P_TOL["rtol"] * np.abs(w)
        assert not bad.any(), (name, np.abs(g - w)[bad].max())


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_every_gradient_leaf_match_jax(setup, jax_grads, remat):
    _, tcfg, _, np_params, batch = setup
    jloss, jgrads = jax_grads
    state = train_state_from_numpy(np_params, tts.sgd(LR), device="cpu")
    loss = tts.asr_loss(
        tcfg, AudioEncoder(tcfg.audio, remat=remat),
        TextDecoder(tcfg.text, max_position=256), state.params,
        tts.batch_to_device(batch, "cpu"), remat=remat)
    loss.backward()
    assert loss.item() == pytest.approx(jloss, rel=1e-5)
    got = _flat(_grads(state.params))
    want = _flat(jgrads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-9, (name, err)
    # the tied head's gradient is its own leaf's, as in JAX
    assert not np.array_equal(got["/decoder/embed"], got["/decoder/lm_head"])
    np.testing.assert_raises(
        AssertionError, np.testing.assert_allclose,
        want["/decoder/embed"], want["/decoder/lm_head"])


def _grads(tree):
    if isinstance(tree, dict):
        return {k: _grads(v) for k, v in tree.items()}
    return tree.grad.numpy()


def test_one_sgd_step_matches_optax(setup, jax_value_and_grad):
    (jloss, jp, _), = _jax_steps(setup, jax_value_and_grad, optax.sgd(LR), 1)
    _, ((loss, params),) = _port_steps(setup, tts.sgd(LR), 1)
    assert loss == pytest.approx(jloss, rel=1e-5)
    _assert_params(params, jp)


def test_two_adamw_steps_match_optax(setup, jax_value_and_grad):
    """optax.adamw(1e-3) and adamw(1e-3) (torch AdamW with optax's
    defaults), after each of two steps. AdamW divides each gradient
    element by that element's own RMS gradient sqrt(v_hat), so the
    gradients' disagreement, at most d = 1e-5 of the leaf's largest
    (the gradient test's bound), moves an update by up to lr * 4 d /
    sqrt(v_hat) (m and v both carry it; factor 2 margin), capped at 2 lr:
    each element gets that slack on top of atol 1e-6 / rtol 1e-5, summed
    over the steps: an element whose gradients nearly cancel gets up to a
    full update. After two
    steps the tied embed and lm_head differ in both packages."""
    want = _jax_steps(setup, jax_value_and_grad, optax.adamw(LR), 2)
    state, got = _port_steps(setup, tts.adamw(LR), 2)
    v = {name: 0.0 for name in _flat(want[0][2])}
    slack = dict.fromkeys(v, 0.0)
    for n, ((jloss, jp, jg), (loss, p)) in enumerate(zip(want, got), 1):
        for name, g in _flat(jg).items():
            v[name] = 0.999 * v[name] + 0.001 * g * g
            rms = np.sqrt(v[name] / (1 - 0.999 ** n)) + 1e-8
            slack[name] = slack[name] + LR * np.minimum(
                2.0, 4e-5 * np.abs(g).max() / rms)
        assert loss == pytest.approx(jloss, rel=1e-5)
        _assert_params(p, jp, slack)
    dec = state.params["decoder"]
    assert dec["lm_head"] is not dec["embed"]
    assert not torch.equal(dec["lm_head"], dec["embed"])
    assert not np.array_equal(want[-1][1]["decoder"]["lm_head"],
                              want[-1][1]["decoder"]["embed"])
    assert state.step == 2
    assert len(state.optimizer.state_dict()["state"]) == len(
        tts.tree_leaves(state.params))


def test_remat_matches_no_remat(setup):
    outs = {remat: _port_steps(setup, tts.sgd(LR), 1, remat=remat)[1][0]
            for remat in (False, True)}
    assert outs[False][0] == pytest.approx(outs[True][0], rel=1e-6)
    _assert_params(outs[True][1], outs[False][1])


def test_loss_decreases_on_repeated_batch(setup):
    state, out = _port_steps(setup, tts.adamw(LR), 8)
    losses = [loss for loss, _ in out]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert state.step == 8


def test_train_state_unties_and_trains_every_float_leaf(setup):
    _, _, jparams, np_params, _ = setup
    assert jparams["decoder"]["lm_head"] is jparams["decoder"]["embed"]
    tied = dict(np_params, decoder=dict(
        np_params["decoder"], lm_head=np_params["decoder"]["embed"]))
    shared = to_torch(tied)["decoder"]
    assert shared["lm_head"] is shared["embed"]
    state = train_state_from_numpy(tied, tts.adamw(LR), device="cpu")
    leaves = tts.tree_leaves(state.params)
    assert all(t.requires_grad and t.is_leaf for t in leaves)
    dec = state.params["decoder"]
    assert dec["lm_head"].data_ptr() != dec["embed"].data_ptr()
    assert torch.equal(dec["lm_head"], dec["embed"])
    group = state.optimizer.param_groups[0]
    assert len(group["params"]) == len(leaves)
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8


QUANT = {"float": None, "int8": dict(bits=8, merge=False),
         "int4": dict(bits=4, merge=False),
         "int8_lm4": dict(bits=8, merge=False, lm_bits=4)}


@pytest.mark.parametrize("tree", QUANT)
def test_forward_full_matches_jax(setup, tree):
    jcfg, tcfg, jparams, np_params, _ = setup
    jdec = jparams["decoder"]
    tdec = to_torch(np_params["decoder"], torch.float32)
    if QUANT[tree]:
        jdec = jquant.quantize_decoder_params(jdec, **QUANT[tree])
        tdec = tquant.quantize_decoder_params(tdec, **QUANT[tree])
    ids = np.asarray([[3, 7, 1, 9, 2, 11, 4]], np.int32)
    jd = JDecoder(jcfg.text, max_position=64)
    want = np.asarray(jd.forward_full(jdec, jd.embed(jdec, jnp.asarray(ids)),
                                      jnp.arange(7)))
    td = TextDecoder(tcfg.text, max_position=64)
    hidden = td.embed(tdec, torch.from_numpy(ids).long())
    for remat in (False, True):
        got = td.forward_full(tdec, hidden, torch.arange(7), remat=remat)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), want, **LOGIT_TOL)


@pytest.mark.parametrize("case,kernel", [
    ("int8", "K5"), ("int4", "K4"), ("flash", "K3")])
def test_forward_full_raises_where_a_kernel_has_no_backward(
        setup, monkeypatch, case, kernel):
    """With a gradient required, a path through K3, K4 or K5 raises
    (never a silently detached result); without one it runs."""
    _, tcfg, _, np_params, _ = setup
    tdec = to_torch(np_params["decoder"], torch.float32)
    if case == "flash":
        monkeypatch.setenv("ASR_ATTN_IMPL", "flash")
    else:
        tdec = tquant.quantize_decoder_params(tdec, **QUANT[case])
    td = TextDecoder(tcfg.text, max_position=64)
    hidden = torch.randn(1, 5, tcfg.text.hidden_size, requires_grad=True)
    with pytest.raises(RuntimeError, match=f"{kernel} .* has no backward"):
        td.forward_full(tdec, hidden, torch.arange(5))
    with torch.no_grad():
        assert torch.isfinite(td.forward_full(tdec, hidden,
                                              torch.arange(5))).all()


def test_matmul_f32_gradient(rng):
    """The CUDA bf16 branch's backward (``_MatmulF32``): on meta tensors
    (``aten::mm.dtype`` has no CPU kernel) it gives each operand a
    gradient of its dtype and shape; its formula on the CPU equals
    autograd through the CPU branch's float32 upcast."""
    a = torch.empty(6, 8, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    b = torch.empty(8, 5, dtype=torch.bfloat16, device="meta",
                    requires_grad=True)
    y = tq._MatmulF32.apply(a, b)
    assert y.dtype == torch.float32
    y.sum().backward()
    assert a.grad.dtype == b.grad.dtype == torch.bfloat16
    assert a.grad.shape == a.shape and b.grad.shape == b.shape

    a = torch.from_numpy(rng.standard_normal((6, 8), np.float32)).bfloat16()
    b = torch.from_numpy(rng.standard_normal((8, 5), np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((6, 5), np.float32))
    ctx = type("Ctx", (), {"saved_tensors": (a, b),
                           "needs_input_grad": (True, True)})()
    ga, gb = tq._MatmulF32.backward(ctx, g)
    a.requires_grad_(), b.requires_grad_()
    tq.matmul_f32(a, b).backward(g)
    assert torch.equal(ga, a.grad) and torch.equal(gb, b.grad)


def test_bf16_step_is_finite(setup):
    """A bf16 state trains (the lm_head through ``matmul_f32``)."""
    _, tcfg, _, np_params, batch = setup
    state = train_state_from_numpy(np_params, tts.sgd(LR),
                                   dtype=torch.bfloat16, device="cpu")
    step = tts.make_train_step(tcfg, tts.sgd(LR), max_position=256,
                               device="cpu")
    state, loss = step(state, batch)
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(t.dtype == torch.bfloat16
               for t in tts.tree_leaves(state.params))


def test_batched_encoder_matches_per_row_calls(setup, rng):
    """``AudioEncoder.batch`` equals the single-clip call row by row, at
    per-row frame counts (JAX's vmap over (mel, n_frames))."""
    _, tcfg, _, np_params, _ = setup
    enc_p = to_torch(np_params["encoder"], torch.float32)
    enc = AudioEncoder(tcfg.audio)
    cf = tcfg.audio.chunk_frames
    n_frames = [3 * cf, 2 * cf + 37, 51]
    mel = np.zeros((3, tcfg.audio.num_mel_bins, 3 * cf), np.float32)
    for r, n in enumerate(n_frames):
        mel[r, :, :n] = rng.standard_normal((tcfg.audio.num_mel_bins, n))
    flat, n_valid = enc.batch(enc_p, torch.from_numpy(mel),
                              torch.tensor(n_frames))
    for r, n in enumerate(n_frames):
        want, nv = enc(enc_p, torch.from_numpy(mel[r]), n)
        assert int(n_valid[r]) == nv
        torch.testing.assert_close(flat[r], want, atol=1e-6, rtol=1e-6)
