"""The port's mesh paths against the JAX package: engine and serving.

Four gloo ranks on the CPU (``torch_parallel_ranks.RankPool``, spawned
once for the file) run the port's engine and continuous batcher SPMD on
('dp', 'tp') meshes at ``tiny_test_config()`` with the full vocabulary;
the JAX package's single-device engine gives the reference tokens in this
process. float32 greedy tokens must be equal: tp = 2 (float32, int8 and
blocked int4 weights; JAX's int4 reference has the int8 lm_head that
blocked int4 forces), dp = 2 and dp = 4 (every quantization, the int8 KV
slab, a lone utterance), mesh serving (JAX's two dp-mesh serving cases,
and tp = 2; against the rows of JAX's batch, each row's tokens its
utterance's alone). The collective structure is pinned: 2 all-reduces per layer
in a tp decode step plus the embedding's, one all-gather of the logits,
and none in a dp rank's decode. JAX's tp refusals raise with JAX's
messages. Under tp = 2 a float engine's batcher builds its int8 serving
copy bit-equal to the whole decoder quantized, then sharded, and
``serving_precision="auto"`` gives the one-device port's tokens and JAX's
tp batcher's.
"""

import torch_threads  # noqa: F401  (first: pins torch's CPU threads)

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3_asr_rs_tpu import config as jconfig
from qwen3_asr_rs_tpu.parallel.mesh import make_mesh as jax_make_mesh
from qwen3_asr_rs_tpu.runtime.engine import AsrEngine as JaxEngine
from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

import torch_parallel_ranks as ranks

LENGTHS = (20000, 9000, 16000, 12000)
INT4G_ENV = {"ASR_INT4_GROUP": "16"}  # the tiny model's hidden dims
# (engine keywords, environment) of each mode; int4 with the int8 lm_head
# that blocked int4 forces under tp
MODES = {
    "float32": ({}, {}),
    "int8": ({"quantize": "int8"}, {}),
    "int4": ({"quantize": "int4"}, {"ASR_LM_BITS": "8"}),
    "int4g": ({"quantize": "int4g"}, INT4G_ENV),
    "lm8": ({"quantize": "lm8"}, {}),
    "int8 KV": ({"kv_dtype": "int8"}, {}),
}


@pytest.fixture(scope="module")
def pool():
    p = ranks.RankPool(4)
    yield p
    p.close()


@pytest.fixture(scope="module")
def clips():
    rng = np.random.default_rng(0)
    return [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in LENGTHS]


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(jnp.asarray, ranks.engine_params())


def _jax_engine(params, env=None, **kw):
    with ranks.environ(env or {}):
        return JaxEngine(model_dir=None, dtype=jnp.float32,
                         max_new_tokens=ranks.MAX_NEW, chunk_buckets=(2,),
                         config=ranks.engine_config(jconfig), params=params,
                         tokenizer=ranks.Tok(), **kw)


_JAX = {}


def _jax_tokens(params, clips, name):
    """JAX's single-device raw outputs of the batch (cached per mode; a
    batch row's tokens are its utterance's alone)."""
    kw, env = MODES[name]
    if name not in _JAX:
        eng = _jax_engine(params, env, **kw)
        with ranks.environ(env):
            _JAX[name] = [r.raw_output for r in eng.transcribe_batch(clips)]
    return _JAX[name]


def _varied(outs):
    """The reference must not be one token repeated: the weights' scale
    gives the tiny model distinct greedy tokens."""
    assert len({t for o in outs for t in o.split()}) > 2, outs


@pytest.mark.parametrize("mode", ["float32", "int8", "int4"])
def test_tp2_engine_tokens_match_jax(pool, clips, jax_params, mode):
    """tp = 2 (q/k/v, gate/up column shards, o/down row shards, vocab
    shards) == JAX's single-device engine; blocked int4 against JAX's int4
    with the int8 lm_head it forces under tp."""
    want = _jax_tokens(jax_params, clips, mode)
    _varied(want)
    res = pool.run("engine_tokens", 2, 1, 2, clips, **MODES[mode][0])
    assert res[2] is None and res[3] is None
    for outs, counts, n_gen in res[:2]:
        assert outs == want
        assert counts["all_reduce"] > 0 and counts["all_gather"] > 0


def test_mesh_of_ones_is_no_mesh(pool, clips, jax_params):
    """A 1 x 1 mesh runs the no-mesh engine and pool: no collective, and
    a pool of the slots asked for, all on the one rank."""
    want = _jax_tokens(jax_params, clips, "float32")
    outs, counts, _ = pool.run("engine_tokens", 1, 1, 1, clips)[0]
    assert outs == want and counts == {}
    outs, n_slots, n_local, _ = pool.run("serving_tokens", 1, 1, 1,
                                         clips[:3], n_slots=3,
                                         segment_steps=2)[0]
    assert outs == want[:3] and n_slots == n_local == 3


def test_dp2_tp2_engine_tokens_match_jax(pool, clips, jax_params):
    """A 2 x 2 mesh: each dp rank's rows through the tp-sharded path."""
    want = _jax_tokens(jax_params, clips, "float32")
    res = pool.run("engine_tokens", 4, 2, 2, clips)
    for outs, counts, n_gen in res:
        assert outs == want and counts["all_reduce"] > 0
        assert len(n_gen) == 4


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("mode", list(MODES))
def test_dp_engine_tokens_match_jax(pool, clips, jax_params, dp, mode):
    """dp = 2 and 4: each rank runs its rows through the whole
    single-device path (every quantization, int8 KV) with no collective;
    every rank returns the whole batch's tokens in order."""
    kw, env = MODES[mode]
    want = _jax_tokens(jax_params, clips, mode)
    res = pool.run("engine_tokens", dp, dp, 1, clips, env=env, **kw)
    for outs, counts, n_gen in res[:dp]:
        assert outs == want
        assert counts == {}
        assert len(n_gen) == 4


@pytest.mark.parametrize("dp", [2, 4])
def test_dp_lone_utterance_matches_jax(pool, clips, jax_params, dp):
    """A lone utterance pads the batch to dp rows (right-aligned, the pad
    rows born done) and gives JAX's tokens of its row in a batch."""
    want = _jax_tokens(jax_params, clips, "float32")[:1]
    res = pool.run("engine_tokens", dp, dp, 1, clips[:1])
    for outs, _, n_gen in res[:dp]:
        assert outs == want
        assert len(n_gen) == dp and n_gen[1:] == [0] * (dp - 1)


def test_dp_sampled_batch_matches_jax_dp(pool, clips, jax_params):
    """A sampled batch on dp = 2 gives JAX's dp = 2 tokens: each rank draws
    with ``fold_in(PRNGKey(seed), rank)`` over its own rows, as JAX's
    shard_map does (so not the one-device run's tokens)."""
    from qwen3_asr_rs_tpu.runtime.sampling import (
        SamplingParams as JSamplingParams,
    )

    mesh = jax_make_mesh(n_devices=2, dp=2)
    assert dict(mesh.shape) == {"dp": 2, "tp": 1}
    jeng = _jax_engine(jax_params, mesh=mesh)
    for sampling in (dict(temperature=0.8, top_k=50, top_p=0.9, seed=3),
                     dict(temperature=1.0, seed=2**33 + 1)):
        want = [r.raw_output for r in jeng.transcribe_batch(
            clips, sampling=JSamplingParams(**sampling))]
        one = [r.raw_output for r in _jax_engine(jax_params).transcribe_batch(
            clips, sampling=JSamplingParams(**sampling))]
        assert want != one
        res = pool.run("engine_tokens", 2, 2, 1, clips, sampling=sampling)
        assert res[0][0] == res[1][0] == want


def test_dp_sampled_serving_matches_jax_mesh_batcher(pool, clips,
                                                     jax_params):
    """A sampled burst on a dp = 2 pool (4 slots, 2 per rank): each rank's
    slots draw at their rows of the whole pool, as JAX's GSPMD batcher on
    a dp = 2 mesh draws, so every request's tokens are JAX's."""
    from qwen3_asr_rs_tpu.runtime.serving import (
        ContinuousBatcher as JaxBatcher,
    )
    from qwen3_asr_rs_tpu.runtime.serving import Request as JaxRequest

    request_kw = [dict(temperature=0.9), {}, dict(temperature=0.8,
                                                  top_p=0.9),
                  dict(temperature=1.0)]
    batcher = JaxBatcher(_jax_engine(jax_params,
                                     mesh=jax_make_mesh(n_devices=2, dp=2)),
                         n_slots=4, segment_steps=2,
                         prefill_chunk_tokens=None, encode_window_groups=None)
    reqs = [JaxRequest(c, **kw) for c, kw in zip(clips, request_kw)]
    for r in reqs:
        batcher.submit(r)
    for _ in range(400):
        if all(r.event.is_set() for r in reqs):
            break
        batcher.step()
    want = [r.result.raw_output for r in reqs]
    res = pool.run("serving_tokens", 2, 2, 1, clips, n_slots=4,
                   segment_steps=2, request_kw=request_kw)
    assert res[0][0] == want and res[1][0] is None


def test_tp_decode_collective_structure(pool):
    """A tp decode step: 2 all-reduces per layer (o and down) plus the
    vocab-parallel embedding's, and one all-gather of the logits; the
    slab holds the rank's KV heads. A prefill of embeddings: the layers'
    all-reduces and the logits' all-gather."""
    res = pool.run("decode_step_collectives", 2, 1, 2)
    for r in res[:2]:
        layers = r["layers"]
        assert r["step"] == {"all_reduce": 2 * layers + 1, "all_gather": 1}
        assert r["prefill"] == {"all_reduce": 2 * layers, "all_gather": 1}
        assert r["local_kv_heads"] == r["slab_heads"] == 1


def test_dp_rank_decode_has_no_collectives(pool, clips):
    res = pool.run("dp_decode_collectives", 2, 2, clips[0])
    for counts, steps in res[:2]:
        assert counts == {} and steps > 0


def test_tp_refusals_match_jax(pool, jax_params):
    """int8 KV, int4g, lm8 and speculative decoding on a tp mesh raise
    the JAX engine's ValueErrors, with JAX's messages."""
    mesh = jax_make_mesh(n_devices=2, tp_divisor_of=2)
    assert dict(mesh.shape) == {"dp": 1, "tp": 2}
    want = {}
    for name, kw in (("int8 KV", {"kv_dtype": "int8"}),
                     ("int4g", {"quantize": "int4g"}),
                     ("lm8", {"quantize": "lm8"}),
                     ("speculative", {"speculative": "int8"})):
        with pytest.raises(ValueError) as e:
            _jax_engine(jax_params, mesh=mesh, **kw)
        want[name] = str(e.value)
    res = pool.run("engine_refusals", 2, 1, 2)
    assert res[0] == res[1] == want


def test_batcher_under_dp_mesh_matches_offline(pool, clips, jax_params):
    """JAX's ``test_batcher_under_dp_mesh_matches_offline``: dp = 4, two
    slots asked (rounded up to 4, one per rank), three requests; with
    chunked admission (16-token chunks) every admission is chunked."""
    want = _jax_tokens(jax_params, clips, "float32")[:3]
    for chunk in (None, 16):
        res = pool.run("serving_tokens", 4, 4, 1, clips[:3], n_slots=2,
                       segment_steps=2, prefill_chunk_tokens=chunk)
        outs, n_slots, n_local, segments = res[0]
        assert outs == want
        assert n_slots == 4 and n_local == 1
        assert all(r[1:] == res[0][1:] for r in res[1:])


def test_serving_int8_kv_on_dp_mesh(pool, clips, jax_params):
    """JAX's ``test_serving_int8_kv_on_dp_mesh``: dp = 2, int8 slab."""
    want = _jax_tokens(jax_params, clips, "int8 KV")[:2]
    res = pool.run("serving_tokens", 2, 2, 1, clips[:2], n_slots=2,
                   segment_steps=2, kv_dtype="int8")
    assert res[0][0] == want and res[0][1:3] == (2, 1)


def test_serving_on_tp_mesh(pool, clips, jax_params):
    """tp = 2: every rank holds its KV heads of every slot."""
    want = _jax_tokens(jax_params, clips, "float32")[:3]
    res = pool.run("serving_tokens", 2, 1, 2, clips[:3], n_slots=2,
                   segment_steps=2)
    assert res[0][0] == want and res[0][1:3] == (2, 2)


def test_streaming_on_tp_mesh(pool, clips):
    """A streaming transcriber over a tp = 2 engine (eager steps, the
    shard's decoder and slab) gives the one-device port's hypotheses,
    update by update (the port's streaming is held to JAX's in
    ``test_torch_streaming.py``)."""
    want = ranks.stream_texts(0, None, None, clips[0][:32000])
    assert len(want[0]) >= 2
    res = pool.run("stream_texts", 2, 1, 2, clips[0][:32000])
    assert res[0] == res[1] == want


# ---- the batcher's int8 copy under tp -------------------------------------


@pytest.mark.parametrize("precision", ["auto", "int8"])
def test_tp2_serving_int8_copy_is_whole_weight_quantized_then_sharded(
        pool, precision):
    """A float engine's batcher builds its int8 copy under tp = 2, bit
    for bit the whole decoder quantized (unmerged, int8 lm_head), then
    cut by ``quantized_decoder_param_specs``: the row-parallel o and down
    take each column's absmax over tp (one MAX all-reduce each, the
    construction's only collectives), where a rank quantizing its pieces
    alone would give other scales."""
    res = pool.run("serving_int8_copy", 2, 1, 2, precision)
    assert res[2] is None and res[3] is None
    alone_differs = set()
    for got, want, alone, counts in res[:2]:
        assert got.keys() == want.keys()
        assert "/layers/o_w_q" in got and "/lm_head_q" in got
        for name, w in want.items():
            assert got[name].dtype == w.dtype, name
            np.testing.assert_array_equal(got[name], w, name)
        assert counts == {"all_reduce": 2}
        for name in want:
            if not np.array_equal(alone[name], want[name]):
                alone_differs.add(name.split("/")[-1])
    assert alone_differs == {"o_w_q", "o_w_s", "down_w_q", "down_w_s"}


def _jax_tp_auto_serving(params, clips):
    """JAX's batcher on a tp = 2 CPU mesh with ``serving_precision=
    "auto"`` (3 slots, 2-step segments): the requests' raw outputs."""
    from qwen3_asr_rs_tpu.runtime.serving import (
        ContinuousBatcher as JaxBatcher,
    )
    from qwen3_asr_rs_tpu.runtime.serving import Request as JaxRequest

    mesh = jax_make_mesh(n_devices=2, tp_divisor_of=2)
    batcher = JaxBatcher(_jax_engine(params, mesh=mesh), n_slots=3,
                         segment_steps=2, serving_precision="auto")
    reqs = [JaxRequest(c) for c in clips]
    for r in reqs:
        batcher.submit(r)
    for _ in range(400):
        if all(r.event.is_set() for r in reqs):
            break
        batcher.step()
    return [r.result.raw_output for r in reqs]


def test_tp2_auto_serving_tokens_match_one_device(pool, clips, jax_params):
    """``serving_precision="auto"`` at tp = 2 (float32; four requests in
    three slots: float segments while more than two are live, int8
    segments after) gives the one-device port's auto run's tokens and
    JAX's tp = 2 auto batcher's."""
    kw = dict(n_slots=3, segment_steps=2, serving_precision="auto",
              with_variants=True)
    one = pool.run("serving_tokens", 1, 1, 1, clips, **kw)[0]
    res = pool.run("serving_tokens", 2, 1, 2, clips, **kw)
    want = one[0]
    _varied(want)
    assert res[0][0] == want and res[1][0] is None
    assert res[0][4] == res[1][4] == one[4] == [("greedy", "bf16"),
                                                ("greedy", "int8")]
    assert _jax_tp_auto_serving(jax_params, clips) == want
