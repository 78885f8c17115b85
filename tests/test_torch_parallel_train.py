"""The port's ``parallel/`` against the JAX package: meshes, spec trees,
blocked int4, the tp-sharded decoder and the sharded train step.

``mesh_shape`` gives JAX's ``make_mesh`` shapes and errors; every spec
tree matches JAX's ``PartitionSpec``s leaf for leaf; blocked int4 packs
byte-equal to JAX's. On four gloo ranks (``torch_parallel_ranks``): the
tp = 2 ``forward_full`` is JAX's unsharded one within atol/rtol 1e-4
(JAX's tolerance for its sharded decoder), and one SGD step on dp = 2,
tp = 2 and 2 x 2 meshes gives ``jax.value_and_grad(asr_loss)``'s loss
(rel 1e-5) and every gradient leaf (within 1e-5 of the leaf's largest
JAX magnitude plus 1e-9, the tolerances of ``test_torch_training.py``) on
the whole batch, whose rows carry unequal loss masks: the loss is the
global masked mean, not a mean of the ranks' means. Checkpoints of an
AdamW state on dp = 2, tp = 2 and 2 x 2 meshes hold whole tensors (the
one-device save of the same state), are written by the lead rank alone,
restore across mesh shapes with each rank its own pieces, and the next
step's loss equals the uninterrupted run's; ``save_checkpoint(mesh=)``
writes the one-device export.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.models.audio_encoder import AudioEncoder as JEncoder
from qwen3_asr_rs_tpu.models.text_decoder import TextDecoder as JDecoder
from qwen3_asr_rs_tpu.ops.pallas import quant_matmul as jqm
from qwen3_asr_rs_tpu.parallel import mesh as jmesh
from qwen3_asr_rs_tpu.parallel import sharding as jsharding
from qwen3_asr_rs_tpu.training import train_step as jts
from qwen3_asr_rs_tpu.weights import quantize as jquant
from qwen3_asr_rs_tpu_torch import config as tconfig
from qwen3_asr_rs_tpu_torch import parallel as tparallel
from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder
from qwen3_asr_rs_tpu_torch.ops import quant as tq
from qwen3_asr_rs_tpu_torch.parallel import sharding as tsharding
from qwen3_asr_rs_tpu_torch.training.train_step import tree_leaves
from qwen3_asr_rs_tpu_torch.weights import quantize as tquant
from qwen3_asr_rs_tpu_torch.weights.convert import (
    init_decoder_params_np,
    init_encoder_params_np,
    to_torch,
)

import torch_parallel_ranks as ranks
from test_training import make_batch


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(4)
    yield p
    p.close()


# ---- meshes and specs (no ranks) -----------------------------------------


@pytest.mark.parametrize("kw", [
    dict(n_devices=8, tp_divisor_of=8), dict(n_devices=8, tp_divisor_of=2),
    dict(n_devices=4, dp=2), dict(n_devices=4, tp=1),
    dict(n_devices=2, tp_divisor_of=2), dict(n_devices=6, tp_divisor_of=8),
])
def test_mesh_shape_matches_jax(kw):
    """JAX's cases (``tests/test_parallel.py``) and a few more."""
    want = jmesh.make_mesh(**kw).shape
    n = kw.pop("n_devices")
    assert tparallel.mesh_shape(n, **kw) == (want["dp"], want["tp"])


def test_mesh_shape_error_matches_jax():
    with pytest.raises(ValueError) as e:
        jmesh.make_mesh(n_devices=4, dp=3)
    with pytest.raises(ValueError, match=r"dp\(3\) \* tp\(1\)") as t:
        tparallel.mesh_shape(4, dp=3)
    assert str(t.value) == str(e.value)


def _as_tuples(tree):
    if isinstance(tree, dict):
        return {k: _as_tuples(v) for k, v in tree.items()}
    return tuple(tree)


SPEC_TREES = [("decoder_param_specs", (True,)),
              ("decoder_param_specs", (False,)),
              ("quantized_decoder_param_specs", (True,)),
              ("quantized_decoder_param_specs", (False,)),
              ("int4_decoder_param_specs", (True,)),
              ("int4_decoder_param_specs", (False,)),
              ("encoder_param_specs", (14, 2)),
              ("encoder_param_specs", (14, 4)),
              ("encoder_param_specs", (4, 2))]


@pytest.mark.parametrize("name,args", SPEC_TREES)
def test_spec_tree_matches_jax(name, args):
    want = getattr(jsharding, name)(*args)
    got = getattr(tsharding, name)(*args)
    assert _as_tuples(got) == _as_tuples(want)


def test_match_specs_matches_jax():
    params = {"embed": 0, "extra": 1, "layers": {"q_w": 2, "qkv_w_q": 3},
              "final_ln_w": 4}
    want = jsharding.match_specs(params, jsharding.decoder_param_specs())
    got = tsharding.match_specs(params, tsharding.decoder_param_specs())
    assert _as_tuples(got) == _as_tuples(want)


# ---- blocked int4 (no ranks) ---------------------------------------------


def _bits(t):
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.tobytes(), a.shape, str(a.dtype)


@pytest.mark.parametrize("blocks", [1, 2, 4])
def test_blocked_int4_packing_matches_jax(blocks):
    rng = np.random.default_rng(blocks)
    w = rng.standard_normal((16, 32)).astype(np.float32)
    packed, s = tq.quantize_weight_int4(torch.from_numpy(w), blocks=blocks)
    jp, js = jqm.quantize_weight_int4(jnp.asarray(w), blocks=blocks)
    assert _bits(packed) == _bits(jp) and _bits(s) == _bits(js)
    if blocks > 1:
        assert _bits(tq.unpack_int4_blocked(packed)) == _bits(
            jqm.unpack_int4_blocked(jp))
    with pytest.raises(ValueError, match="divisible by 2\\*blocks"):
        tq.quantize_weight_int4(torch.ones(4, 12), blocks=4)


def test_blocked_decoder_tree_matches_jax():
    """``tp_blocks = 2`` (its tree is JAX's byte for byte:
    ``test_torch_quant.py``): column weights blocked, row weights plain,
    the lm_head int8; JAX's errors; the blocked product equal to JAX's
    unpack-and-dot; a tp shard's block a plain packing of its columns."""
    cfg = tconfig.tiny_test_config().text
    dec = to_torch(init_decoder_params_np(cfg, scale=0.1), torch.float32)
    got = tquant.quantize_decoder_params(dec, bits=4, merge=False,
                                         tp_blocks=2)
    assert "lm_head_q" in got and "lm_head_q4" not in got
    assert got["layers"]["q_w_q4"].ndim == 4
    assert got["layers"]["o_w_q4"].ndim == 3
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), got)
    for kw in (dict(bits=8, merge=False), dict(bits=4, merge=True)):
        with pytest.raises(ValueError) as e:
            jquant.quantize_decoder_params(jtree, tp_blocks=2, **kw)
        with pytest.raises(ValueError) as t:
            tquant.quantize_decoder_params(got, tp_blocks=2, **kw)
        assert str(t.value) == str(e.value)
    x = np.random.default_rng(1).standard_normal((3, 64)).astype(np.float32)
    lay = {k: v[0] for k, v in got["layers"].items()}
    y = tq.int4_blocked_matmul(torch.from_numpy(x), lay["q_w_q4"],
                               lay["q_w_s"])
    jlay = {k: np.asarray(v[0]) for k, v in jtree["layers"].items()}
    ref = (x @ np.asarray(jqm.unpack_int4_blocked(jlay["q_w_q4"]))
           * jlay["q_w_s"])
    np.testing.assert_allclose(y.numpy(), ref, atol=1e-5, rtol=1e-5)
    half = lay["q_w_s"].shape[0] // 2
    shard = tq.int4_matmul_plain(torch.from_numpy(x), lay["q_w_q4"][:, 1],
                                 lay["q_w_s"][half:])
    np.testing.assert_allclose(shard.numpy(), ref[:, half:], atol=1e-5,
                               rtol=1e-5)


def test_blocked_tree_decodes_on_one_device():
    """A whole blocked tree on one device: the per-layer decode (the
    decode kernel's plain version declines it, as JAX's does) gives JAX's
    logits."""
    from qwen3_asr_rs_tpu.models.text_decoder import KVCache as JCache
    from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache

    cfg = tconfig.tiny_test_config().text
    jcfg = jconfig.tiny_test_config().text
    tree = tquant.quantize_decoder_params(
        to_torch(init_decoder_params_np(cfg, scale=0.1), torch.float32),
        bits=4, merge=False, tp_blocks=2)
    jtree = jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), tree)
    kc = (np.random.default_rng(2).standard_normal(
        (cfg.num_hidden_layers, 1, cfg.num_key_value_heads, 16,
         cfg.head_dim)) * 0.3).astype(np.float32)
    jlog, _ = JDecoder(jcfg, max_position=64).decode_step(
        jtree, jnp.asarray([7], jnp.int32), jnp.int32(9),
        JCache(k=jnp.asarray(kc), v=jnp.asarray(kc)))
    tdec = TextDecoder(cfg, max_position=64)
    assert not tdec._use_fused_step(tree, torch.device("cuda"))
    tlog, _ = tdec.decode_step(tree, torch.tensor([7]), 9,
                               KVCache(k=torch.from_numpy(kc.copy()),
                                       v=torch.from_numpy(kc.copy())))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=1e-5,
                               rtol=1e-5)


# ---- the sharded decoder and placement (ranks) ----------------------------


def test_tp2_forward_full_matches_jax(pool):
    """JAX's ``test_tp_sharded_decoder_matches_single_device``: the tp = 2
    decoder's logits against JAX's unsharded ``forward_full``."""
    cfg = jconfig.tiny_test_config().text
    params = init_decoder_params_np(tconfig.tiny_test_config().text)
    ids = np.asarray([[5, 8, 1, 13, 2]], np.int32)
    jdec = JDecoder(cfg, max_position=64)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    want = np.asarray(jdec.forward_full(jp, jdec.embed(jp, ids),
                                        jnp.arange(5)))
    res = pool.run("forward_full", 2, 1, 2, params, ids)
    for logits, counts in res[:2]:
        np.testing.assert_allclose(logits, want, atol=1e-4, rtol=1e-4)
        layers = cfg.num_hidden_layers
        assert counts == {"all_reduce": 2 * layers + 1, "all_gather": 1}


def test_shards_placements_and_prefetch_rows(pool):
    """``shard_params`` pieces on a 2 x 2 mesh, ``named_shardings``'
    placements, and ``prefetch_to_device(mesh=)`` giving each rank its dp
    rows."""
    cfg = tconfig.tiny_test_config().text
    params = init_decoder_params_np(cfg)
    res = pool.run("placements", 4, 2, 2, params)
    h, nq, nkv, d = (cfg.hidden_size, cfg.num_attention_heads,
                     cfg.num_key_value_heads, cfg.head_dim)
    for shapes, q_place, embed_place, rows, (r_dp, _) in res:
        assert shapes["q_w"] == (2, h, nq * d // 2)
        assert shapes["k_w"] == (2, h, nkv * d // 2)
        assert shapes["o_w"] == (2, nq * d // 2, h)
        assert shapes["down_w"] == (2, cfg.intermediate_size // 2, h)
        assert shapes["input_ln_w"] == (2, h)
        assert shapes["embed"] == shapes["lm_head"] == (
            cfg.vocab_size // 2, h)
        assert q_place == "(Replicate(), Shard(dim=2))"
        assert embed_place == "(Replicate(), Shard(dim=0))"
        want = np.arange(24).reshape(8, 3)[4 * r_dp: 4 * r_dp + 4]
        assert rows == [want.tolist()]


# ---- the sharded train step (ranks) ---------------------------------------


@pytest.fixture(scope="module")
def train_setup():
    """(numpy params, a 4-row batch with unequal masks, JAX's loss and
    gradients on the whole batch)."""
    jcfg, tcfg = jconfig.tiny_test_config(), tconfig.tiny_test_config()
    params = {"encoder": init_encoder_params_np(tcfg.audio),
              "decoder": init_decoder_params_np(tcfg.text)}
    batch = make_batch(jcfg, 4, np.random.default_rng(0))
    batch["loss_mask"][1, -9:-4] = 0.0   # rank 0 of dp = 2: 11 targets
    batch["loss_mask"][3] = 0.0          # rank 1: 8
    enc, dec = JEncoder(jcfg.audio), JDecoder(jcfg.text, max_position=256)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jts.asr_loss(jcfg, enc, dec, p, batch, remat=False)))(
            jax.tree_util.tree_map(jnp.asarray, params))
    return params, batch, float(loss), jax.tree_util.tree_map(np.asarray,
                                                              grads)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _whole_grads(res, tp):
    """Every leaf's whole gradient from the ranks' shards: the pieces of
    the tp ranks at dp index 0 joined along the leaf's tp dim."""
    cfg = tconfig.tiny_test_config()
    specs = _flat(tsharding.match_specs(res[0][1], {
        "encoder": tsharding.encoder_param_specs(
            cfg.audio.encoder_attention_heads, tp),
        "decoder": tsharding.decoder_param_specs()}))
    pieces = [_flat(r[1]) for r in sorted(
        (r for r in res if r is not None and r[2][0] == 0),
        key=lambda r: r[2][1])]
    out = {}
    for name, spec in specs.items():
        parts = [p[name] for p in pieces]
        out[name] = (np.concatenate(parts, spec.index("tp"))
                     if "tp" in spec and tp > 1 else parts[0])
    return out


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_sharded_train_step_matches_jax(pool, train_setup, dp, tp):
    params, batch, jloss, jgrads = train_setup
    res = pool.run("train_step", dp * tp, dp, tp, params, batch)
    res = [r for r in res if r is not None]
    assert len(res) == dp * tp
    for losses, _, _ in res:
        assert losses[0] == pytest.approx(jloss, rel=1e-5)
    got, want = _whole_grads(res, tp), _flat(jgrads)
    assert got.keys() == want.keys()
    for name, w in want.items():
        assert got[name].shape == w.shape, name
        err = np.abs(got[name] - w).max()
        assert err <= 1e-5 * np.abs(w).max() + 1e-9, (name, err)


def test_mean_of_rank_means_would_differ(train_setup):
    """The unequal masks matter: DDP's mean of the two ranks' own masked
    means is another number than the whole batch's masked mean, farther
    from it than ten times the tolerance the step is held to."""
    from qwen3_asr_rs_tpu_torch.models.audio_encoder import AudioEncoder
    from qwen3_asr_rs_tpu_torch.training import train_step as tts

    params, batch, jloss, _ = train_setup
    tcfg = tconfig.tiny_test_config()
    enc, dec = AudioEncoder(tcfg.audio), TextDecoder(tcfg.text, 256)
    tp = to_torch(params, torch.float32)
    with torch.no_grad():
        halves = [float(tts.asr_loss(
            tcfg, enc, dec, tp, tts.batch_to_device(
                {k: v[i:i + 2] for k, v in batch.items()}, "cpu"),
            remat=False)) for i in (0, 2)]
    assert abs(np.mean(halves) - jloss) > 10 * 1e-5 * jloss


# ---- checkpoints of a sharded state (ranks) -------------------------------

CKPT_MESHES = [(2, 1), (1, 2), (2, 2)]


def _one_device_step():
    from qwen3_asr_rs_tpu_torch.training import adamw
    from qwen3_asr_rs_tpu_torch.training import train_step as tts

    return tts.make_train_step(tconfig.tiny_test_config(), adamw(1e-3),
                               max_position=256, remat=False, device="cpu")


@pytest.fixture(scope="module")
def ckpt_runs(pool, train_setup, tmp_path_factory):
    """One AdamW step on one device, saved to ``<root>/one`` (and
    exported to ``<root>/one_export``), with the loss of the step after
    it; then ``checkpoint_cases`` on each mesh of ``CKPT_MESHES``."""
    from qwen3_asr_rs_tpu_torch.training import save_train_state
    from qwen3_asr_rs_tpu_torch.weights.export import save_checkpoint

    params, batch, _, _ = train_setup
    root = tmp_path_factory.mktemp("ckpt")
    step = _one_device_step()
    state, _ = step(step.init(to_torch(params, torch.float32)), batch)
    save_train_state(root / "one", state)
    save_checkpoint(root / "one_export", state.params["encoder"],
                    state.params["decoder"], tconfig.tiny_test_config())
    _, one_next = step(state, batch)
    runs = {(dp, tp): [r for r in pool.run("checkpoint_cases", dp * tp, dp,
                                           tp, params, batch, str(root))
                       if r is not None]
            for dp, tp in CKPT_MESHES}
    return root, float(one_next), runs


def _load(path):
    return torch.load(path / "state.pt", map_location="cpu",
                      weights_only=True)


def _assert_states_equal(got, want):
    assert got["step"] == want["step"]
    g, w = _flat(got["params"]), _flat(want["params"])
    assert g.keys() == w.keys()
    for name in w:
        assert g[name].shape == w[name].shape, name
        np.testing.assert_allclose(g[name].numpy(), w[name].numpy(),
                                   atol=1e-6, rtol=0, err_msg=name)
    go, wo = got["opt_state"], want["opt_state"]
    assert go["param_groups"] == wo["param_groups"]
    assert go["state"].keys() == wo["state"].keys()
    for i, per in wo["state"].items():
        for k, v in per.items():
            assert go["state"][i][k].shape == v.shape, (i, k)
            np.testing.assert_allclose(go["state"][i][k].numpy(), v.numpy(),
                                       atol=1e-6, rtol=0, err_msg=(i, k))


def _names(tree, prefix=""):
    """``tree`` with each leaf replaced by its ``_flat`` name."""
    if isinstance(tree, dict):
        return {k: _names(v, f"{prefix}/{k}") for k, v in tree.items()}
    return prefix


def _piece(whole, spec, coord, tp):
    """The rank at ``coord`` (dp, tp)'s piece of a whole numpy leaf."""
    if "tp" not in spec or tp == 1:
        return whole
    return np.split(whole, tp, axis=spec.index("tp"))[coord[1]]


@pytest.mark.parametrize("dp,tp", CKPT_MESHES)
def test_mesh_checkpoint_equals_one_device_save(ckpt_runs, dp, tp):
    """A state saved on the mesh (synchronously and by the async
    checkpointer) holds whole tensors: the one-device save of the same
    state, parameters and AdamW moments, within float32 1e-6."""
    root, _, _ = ckpt_runs
    want = _load(root / "one")
    _assert_states_equal(_load(root / f"dp{dp}tp{tp}" / "sync"), want)
    _assert_states_equal(
        _load(root / f"dp{dp}tp{tp}" / "async" / "step_00000001"), want)


@pytest.mark.parametrize("dp,tp", CKPT_MESHES)
def test_mesh_checkpoint_restores_give_each_rank_its_pieces(ckpt_runs, dp,
                                                            tp):
    """One device -> mesh: each rank holds its own pieces of the saved
    parameters and moments (no rank another's shard). Mesh -> one
    device: a fresh one-device state restored from the mesh's save holds
    the whole saved tensors."""
    from qwen3_asr_rs_tpu_torch.training import restore_train_state

    root, _, runs = ckpt_runs
    saved = _load(root / "one")
    whole = {k: v.numpy() for k, v in _flat(saved["params"]).items()}
    cfg = tconfig.tiny_test_config()
    specs = _flat(tsharding.match_specs(saved["params"], tsharding
                                        .model_param_specs(
                                            cfg.audio.encoder_attention_heads,
                                            tp)))
    state = _one_device_step().init(to_torch(
        {"encoder": init_encoder_params_np(cfg.audio),
         "decoder": init_decoder_params_np(cfg.text)}, torch.float32))
    moments = {  # the optimizer indexes its leaves in tree_leaves order
        name: saved["opt_state"]["state"][i]["exp_avg"].numpy()
        for i, name in enumerate(tree_leaves(_names(saved["params"])))}
    coords = set()
    for r in runs[(dp, tp)]:
        coords.add(tuple(r["coord"]))
        assert r["step"] == 1
        for name, w in whole.items():
            want = _piece(w, specs[name], r["coord"], tp)
            np.testing.assert_array_equal(r["pieces"][name], want, name)
            np.testing.assert_array_equal(
                r["moments"][name],
                _piece(moments[name], specs[name], r["coord"], tp), name)
        if tp > 1:  # some leaf is cut
            assert r["pieces"]["/decoder/layers/q_w"].shape != whole[
                "/decoder/layers/q_w"].shape
    assert len(coords) == dp * tp
    back = restore_train_state(root / f"dp{dp}tp{tp}" / "sync", state)
    assert back.step == 1
    for name, t in _flat(back.params).items():
        np.testing.assert_array_equal(t.detach().numpy(), whole[name], name)


@pytest.mark.parametrize("dp,tp", CKPT_MESHES)
def test_mesh_checkpoint_next_loss_equals_uninterrupted(ckpt_runs,
                                                        train_setup, dp, tp):
    """The step after a restore gives the uninterrupted run's loss: on
    the mesh, exactly; the mesh's run from the one-device checkpoint,
    the one-device run's (rel 1e-5, the sharded step's tolerance); and a
    one-device state restored from a state trained on the mesh, the
    mesh's next loss (rel 1e-5)."""
    from qwen3_asr_rs_tpu_torch.training import restore_train_state

    root, one_next, runs = ckpt_runs
    params, batch, _, _ = train_setup
    for r in runs[(dp, tp)]:
        assert r["restored_loss"] == r["next_loss"]
        assert r["next_loss"] == pytest.approx(one_next, rel=1e-5)
    step = _one_device_step()
    state = restore_train_state(root / f"dp{dp}tp{tp}" / "trained",
                                step.init(to_torch(params, torch.float32)))
    assert state.step == 2
    _, loss = step(state, batch)
    for r in runs[(dp, tp)]:
        assert float(loss) == pytest.approx(r["trained_next"], rel=1e-5)


@pytest.mark.parametrize("dp,tp", CKPT_MESHES)
def test_mesh_checkpoint_one_rank_writes(ckpt_runs, dp, tp):
    """The mesh's lead rank (0, 0) alone renames checkpoint directories
    into place (the synchronous save, the async one and its metric
    journal) and writes the export's safetensors, once each."""
    _, _, runs = ckpt_runs
    for r in runs[(dp, tp)]:
        if tuple(r["coord"]) == (0, 0):
            assert r["writes"] == {"sync": 1, "step_00000001": 1,
                                   "metrics.json": 1,
                                   "model.safetensors": 1}
        else:
            assert r["writes"] == {}


@pytest.mark.parametrize("dp,tp", CKPT_MESHES)
def test_mesh_save_checkpoint_equals_one_device_export(ckpt_runs, dp, tp):
    """``save_checkpoint(mesh=)`` of the mesh's pieces writes the
    one-device export of the same weights: equal tensors, equal
    config."""
    from qwen3_asr_rs_tpu_torch.weights.loader import read_safetensors

    root, _, _ = ckpt_runs
    got_dir, want_dir = root / f"dp{dp}tp{tp}" / "export", root / "one_export"
    got = read_safetensors(got_dir / "model.safetensors")
    want = read_safetensors(want_dir / "model.safetensors")
    assert got.keys() == want.keys()
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), atol=1e-6,
                                   rtol=0, err_msg=name)
    assert ((got_dir / "config.json").read_text()
            == (want_dir / "config.json").read_text())
