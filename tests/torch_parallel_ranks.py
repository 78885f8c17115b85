"""Rank-side cases of ``tests/test_torch_parallel*.py``.

A ``RankPool`` spawns gloo ranks on the CPU once per test file
(``torch.multiprocessing`` spawn) and runs the module-level cases below
on every rank, SPMD, as the port's mesh paths expect. A case builds its
mesh from the first ranks of the pool (``make_mesh(n_devices=)``); ranks
outside it return None. This module imports torch and the port only:
the JAX references stay in the test process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import os
import queue
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# weights of the engine cases: the JAX package's initialisers' numpy twins
# at this scale, where the tiny model's greedy tokens vary along a
# transcript (at the default 0.02 it repeats one token)
SCALE = 0.1
MAX_NEW = 4


class Tok:
    """The tokenizer of the engine cases (as the JAX tests' mock)."""

    def encode(self, s):
        return [101] * 4

    def decode(self, ids):
        return " ".join(map(str, ids))


def engine_config(module):
    """``tiny_test_config()`` of a package's config module with the full
    vocabulary (prompt special tokens are in-vocab)."""
    cfg = module.tiny_test_config()
    return dataclasses.replace(cfg, thinker_config=dataclasses.replace(
        cfg.thinker_config,
        text_config=dataclasses.replace(cfg.text, vocab_size=151936)))


def engine_params():
    """(encoder, decoder) numpy trees of the engine cases."""
    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.weights.convert import (
        init_decoder_params_np,
        init_encoder_params_np,
    )

    cfg = engine_config(tconfig)
    return (init_encoder_params_np(cfg.audio, scale=SCALE),
            init_decoder_params_np(cfg.text, scale=SCALE))


@contextlib.contextmanager
def environ(env):
    """``os.environ`` updated by ``env`` inside the block."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def port_engine(mesh, env=None, **kw):
    """The port's float32 engine of the engine cases on the CPU."""
    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.runtime.engine import AsrEngine

    with environ(env or {}):
        return AsrEngine(None, dtype=torch.float32, max_new_tokens=MAX_NEW,
                         chunk_buckets=(2,), config=engine_config(tconfig),
                         params=engine_params(), tokenizer=Tok(),
                         device="cpu", mesh=mesh, **kw)


def _mesh(n, dp=None, tp=None, tp_divisor_of=2):
    """A mesh over the pool's first n ranks (None on the others)."""
    from qwen3_asr_rs_tpu_torch.parallel import make_mesh

    mesh = make_mesh(n_devices=n, dp=dp, tp=tp, device_type="cpu",
                     tp_divisor_of=tp_divisor_of)
    return mesh if mesh.get_coordinate() is not None else None


def _counted(fn):
    """(fn(), the collectives it issued through ``parallel/comm.py``)."""
    from qwen3_asr_rs_tpu_torch.parallel.comm import COUNTS

    COUNTS.clear()
    out = fn()
    return out, dict(COUNTS)


# ---- cases: engine --------------------------------------------------------


def engine_tokens(n, dp, tp, batch, env=None, sampling=None, **kw):
    """Raw outputs of ``transcribe_batch(batch)`` on a (dp, tp) mesh over
    n ranks, and the collectives the call issued."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    eng = port_engine(mesh, env, **kw)
    if sampling is not None:
        from qwen3_asr_rs_tpu_torch.runtime.sampling import SamplingParams

        sampling = SamplingParams(**sampling)
    out, counts = _counted(lambda: eng.transcribe_batch(batch,
                                                        sampling=sampling))
    return [r.raw_output for r in out], counts, eng.last_stats["n_gen"]


def engine_refusals(n, dp, tp):
    """The errors of the modes a tp mesh refuses: {mode: message}."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    out = {}
    for name, kw in (("int8 KV", {"kv_dtype": "int8"}),
                     ("int4g", {"quantize": "int4g"}),
                     ("lm8", {"quantize": "lm8"}),
                     ("speculative", {"speculative": "int8"})):
        try:
            port_engine(mesh, **kw)
            out[name] = None
        except ValueError as e:
            out[name] = str(e)
    return out


def decode_step_collectives(n, dp, tp):
    """Collectives of one decode step (per-layer path) and of one prefill
    at tp, and of a dp rank's whole decode loop."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch.models.text_decoder import KVCache

    eng = port_engine(mesh)
    dec, params = eng.decoder, eng.dec_params
    cache = KVCache.zeros(dec.cfg, 1, 32, dtype=torch.float32)
    hidden = torch.zeros(1, 8, eng.config.text.hidden_size)
    _, prefill = _counted(lambda: dec.prefill(params, hidden,
                                              torch.arange(8), cache, 8))
    _, step = _counted(lambda: dec.decode_step_token(
        params, torch.tensor([5]), 8, cache))
    return {"prefill": prefill, "step": step,
            "layers": eng.config.text.num_hidden_layers,
            "local_kv_heads": dec.cfg.num_key_value_heads,
            "slab_heads": cache.k.shape[2]}


def dp_decode_collectives(n, dp, clip):
    """A dp rank's decode loop over its two rows: the collectives it
    issued (none) and its decode steps."""
    mesh = _mesh(n, dp, 1)
    if mesh is None:
        return None
    eng = port_engine(mesh)
    _, counts = _counted(lambda: eng._generate(
        [clip] * 2, [None] * 2, np.ones(2, bool)))
    return counts, eng.last_stats["decode_steps"]


def stream_texts(n, dp, tp, clip):
    """A streaming transcriber over ``clip`` in 0.5 s updates: each
    update's hypothesis and the final text (None off the mesh; a
    one-device run with ``n`` = 0)."""
    mesh = _mesh(n, dp, tp) if n else None
    if n and mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch.runtime.streaming import StreamingTranscriber

    stream = StreamingTranscriber(port_engine(mesh), update_interval_s=0.5)
    hyps = []
    for i in range(0, len(clip), 8000):
        update = stream.feed(clip[i:i + 8000])
        if update is not None:
            hyps.append(update.hypothesis)
    return hyps, stream.finalize().raw_output


# ---- cases: serving ------------------------------------------------------


def serving_tokens(n, dp, tp, clips, n_slots, segment_steps,
                   prefill_chunk_tokens=None, serving_precision="engine",
                   with_variants=False, request_kw=None, **kw):
    """Raw outputs of a ContinuousBatcher on the mesh (lead rank: the
    served requests'), its slot count and the mesh's rank count, its
    segments (``with_variants``: and the (variant, precision) pairs they
    ran). ``request_kw``: each request's keywords (temperature, top_p)."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch.runtime.serving import (
        ContinuousBatcher,
        Request,
    )

    b = ContinuousBatcher(port_engine(mesh, **kw), n_slots=n_slots,
                          segment_steps=segment_steps,
                          prefill_chunk_tokens=prefill_chunk_tokens,
                          encode_window_groups=None,
                          serving_precision=serving_precision)
    reqs = [Request(c, **kw) for c, kw in zip(
        clips, request_kw or [{}] * len(clips))]
    b.drive(reqs)
    outs = [r.result.raw_output for r in reqs] if b.lead else None
    out = (outs, b.n_slots, b.n_local, b.stats["segments"])
    return out + (sorted(b.variants_run),) if with_variants else out


def serving_int8_copy(n, dp, tp, precision):
    """A float engine's batcher with ``serving_precision=precision`` on
    the mesh: its int8 copy, the same whole tree quantized (merge=False,
    lm_bits=8) and cut by ``quantized_decoder_param_specs``, and this
    rank's pieces quantized alone, each as {name: numpy}; and the
    collectives the batcher's construction issued."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch.parallel import (
        quantized_decoder_param_specs,
        shard_params,
    )
    from qwen3_asr_rs_tpu_torch.runtime.serving import ContinuousBatcher
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch
    from qwen3_asr_rs_tpu_torch.weights.quantize import (
        quantize_decoder_params,
    )

    eng = port_engine(mesh)
    b, counts = _counted(lambda: ContinuousBatcher(
        eng, n_slots=2, segment_steps=2, serving_precision=precision))
    whole = to_torch(engine_params()[1], torch.float32, "cpu")
    want = shard_params(
        quantize_decoder_params(whole, merge=False, lm_bits=8), mesh,
        quantized_decoder_param_specs())
    alone = quantize_decoder_params(eng.dec_params, merge=False, lm_bits=8)
    return (_numpy_flat(b._params_by_precision["int8"]), _numpy_flat(want),
            _numpy_flat(alone), counts)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _numpy_flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_numpy_flat(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree.detach().numpy().copy()}


# ---- cases: training -----------------------------------------------------


def train_step(n, dp, tp, params, batch, steps=1):
    """Losses of ``steps`` SGD steps on the mesh (each rank its dp rows,
    ``dp_rows``) and this rank's first-step gradient shards, numpy."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.training import dp_rows, sgd
    from qwen3_asr_rs_tpu_torch.training import train_step as tts
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    step = tts.make_train_step(tconfig.tiny_test_config(), sgd(1e-3),
                               max_position=256, remat=True, device="cpu",
                               mesh=mesh)
    state = step.init(to_torch(params, torch.float32, "cpu"))
    losses, grads = [], None
    for i in range(steps):
        state, loss = step(state, dp_rows(batch, mesh))
        losses.append(float(loss))
        if i == 0:
            grads = _numpy_grads(state.params)
    return losses, grads, mesh.get_coordinate()


def checkpoint_cases(n, dp, tp, params, batch, root):
    """Mesh checkpoints of an AdamW state: restore the one-device
    checkpoint ``<root>/one`` into a fresh mesh state (this rank's
    pieces of the parameters and moments, as {name: numpy}); save that
    state with ``save_train_state`` (``<root>/dp{dp}tp{tp}/sync``),
    ``AsyncTrainCheckpointer`` (``.../async``, with a metric) and
    ``save_checkpoint`` (``.../export``), counting this rank's file
    renames and safetensors writes; then the next step's loss
    uninterrupted and after restoring ``.../sync`` into another fresh
    state; then one more step of the uninterrupted state saved to
    ``.../trained`` and the loss of the step after it."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    import collections
    from pathlib import Path

    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.training import (
        AsyncTrainCheckpointer,
        adamw,
        dp_rows,
        restore_train_state,
        save_train_state,
    )
    from qwen3_asr_rs_tpu_torch.training import checkpoint as ckpt_mod
    from qwen3_asr_rs_tpu_torch.training import train_step as tts
    from qwen3_asr_rs_tpu_torch.weights import export
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    cfg = tconfig.tiny_test_config()
    step = tts.make_train_step(cfg, adamw(1e-3), max_position=256,
                               remat=False, device="cpu", mesh=mesh)
    whole = to_torch(params, torch.float32, "cpu")
    rows = dp_rows(batch, mesh)
    root = Path(root)
    out = root / f"dp{dp}tp{tp}"
    writes = collections.Counter()
    replace, write_st = os.replace, export.write_safetensors

    def counted_replace(src, dst):
        writes[Path(dst).name] += 1
        return replace(src, dst)

    def counted_write(path, tensors):
        writes[Path(path).name] += 1
        return write_st(path, tensors)

    os.replace, export.write_safetensors = counted_replace, counted_write
    try:
        state = restore_train_state(root / "one", step.init(whole))
        pieces = _numpy_flat(state.params)
        moments = _numpy_flat(_map(
            lambda p: state.optimizer.state[p]["exp_avg"], state.params))
        save_train_state(out / "sync", state)
        ck = AsyncTrainCheckpointer(out / "async", mesh=mesh)
        ck.save(state, metric=0.5)
        ck.close()
        export.save_checkpoint(out / "export", state.params["encoder"],
                               state.params["decoder"], cfg, mesh=mesh)
    finally:
        os.replace, export.write_safetensors = replace, write_st
    state, next_loss = step(state, rows)
    again = restore_train_state(out / "sync", step.init(whole))
    _, restored_loss = step(again, rows)
    save_train_state(out / "trained", state)
    _, trained_next = step(state, rows)
    return dict(coord=mesh.get_coordinate(), writes=dict(writes),
                pieces=pieces, moments=moments, step=again.step,
                next_loss=float(next_loss),
                restored_loss=float(restored_loss),
                trained_next=float(trained_next))


def _numpy_grads(tree):
    if isinstance(tree, dict):
        return {k: _numpy_grads(v) for k, v in tree.items()}
    return tree.grad.detach().numpy().copy()


def forward_full(n, dp, tp, params, ids, with_grad=False):
    """``forward_full`` logits of the tp-sharded decoder (every rank
    gathers the whole vocabulary) and the collectives it issued."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch import config as tconfig
    from qwen3_asr_rs_tpu_torch.models.text_decoder import TextDecoder
    from qwen3_asr_rs_tpu_torch.parallel import (
        decoder_param_specs,
        shard_params,
    )
    from qwen3_asr_rs_tpu_torch.parallel.comm import mesh_axis
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    cfg = tconfig.tiny_test_config().text
    dec = TextDecoder(cfg, max_position=64, tp=mesh_axis(mesh, "tp"))
    p = shard_params(to_torch(params, torch.float32), mesh,
                     decoder_param_specs())
    ids = torch.as_tensor(ids)
    with torch.set_grad_enabled(with_grad):
        logits, counts = _counted(lambda: dec.forward_full(
            p, dec.embed(p, ids), torch.arange(ids.shape[1])))
    return logits.detach().numpy(), counts


# ---- cases: placement ----------------------------------------------------


def placements(n, dp, tp, params):
    """``shard_params`` piece shapes and ``named_shardings`` placements
    of the decoder spec tree, and ``prefetch_to_device(mesh=)``'s rows."""
    mesh = _mesh(n, dp, tp)
    if mesh is None:
        return None
    from qwen3_asr_rs_tpu_torch.parallel import (
        decoder_param_specs,
        named_shardings,
        shard_params,
    )
    from qwen3_asr_rs_tpu_torch.training import prefetch_to_device
    from qwen3_asr_rs_tpu_torch.weights.convert import to_torch

    specs = decoder_param_specs()
    local = shard_params(to_torch(params, torch.float32), mesh, specs)
    shapes = {k: tuple(v.shape) for k, v in local["layers"].items()}
    shapes.update({k: tuple(local[k].shape) for k in ("embed", "lm_head")})
    places = named_shardings(mesh, specs)
    batch = {"x": np.arange(8 * 3).reshape(8, 3)}
    rows = [b["x"].numpy().tolist()
            for b in prefetch_to_device(iter([batch]), device="cpu",
                                        mesh=mesh)]
    return (shapes, repr(places["layers"]["q_w"]), repr(places["embed"]),
            rows, mesh.get_coordinate())


# ---- the pool ------------------------------------------------------------


def _serve(rank, world, port, tasks, results):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=120))
    while True:
        task = tasks.get()
        if task is None:
            break
        name, args, kw = task
        try:
            results.put((rank, True, globals()[name](*args, **kw)))
        except Exception:  # noqa: BLE001 — reported to the test process
            results.put((rank, False, traceback.format_exc()))
    dist.destroy_process_group()


class RankPool:
    """``world`` gloo ranks on the CPU, spawned once; ``run`` executes a
    case of this module on every rank and returns the per-rank results
    (raising with a rank's traceback if one failed)."""

    def __init__(self, world: int = 4, timeout: float = 240.0):
        ctx = mp.get_context("spawn")
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        self.world, self.timeout = world, timeout
        self.tasks = [ctx.Queue() for _ in range(world)]
        self.results = ctx.Queue()
        self.procs = [ctx.Process(target=_serve, daemon=True,
                                  args=(r, world, port, self.tasks[r],
                                        self.results))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def run(self, name: str, *args, **kw) -> list:
        for q in self.tasks:
            q.put((name, args, kw))
        out = [None] * self.world
        errors = []
        for _ in range(self.world):
            try:
                rank, ok, value = self.results.get(timeout=self.timeout)
            except queue.Empty:
                self.close()
                raise TimeoutError(f"case {name}: a rank did not answer")
            out[rank] = value
            if not ok:
                errors.append(f"rank {rank}:\n{value}")
        if errors:
            raise AssertionError("\n".join(errors))
        return out

    def close(self) -> None:
        for q in self.tasks:
            q.put(None)
        for p in self.procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
