"""Training checkpoint save/resume.

Port of ``qwen3_asr_rs_tpu/training/checkpoint.py`` (orbax there,
``torch.save`` here): a ``TrainState`` (params, the optimizer's state
dict and step) round-trips through one ``state.pt`` per checkpoint
directory, and inference-format safetensors can be exported from a
state at any point with ``weights/export.py``.

On a mesh (a state from ``make_train_step(mesh=).init``, which keeps the
mesh and its spec tree) a checkpoint holds whole tensors, as orbax
writes global arrays: every rank gathers each tp-sharded leaf along its
spec's dim, and the optimizer's per-parameter tensors of that leaf's
shape (AdamW's moments) the same way, on the calling thread (a
collective); then the mesh's lead rank alone writes, and a barrier over
the mesh follows the write. dp ranks hold equal replicas, so the lead's
is the one written. A restore loads the whole tensors on every rank and
cuts this rank's pieces by the template's mesh and specs
(``shard_params``), so a checkpoint written at one mesh shape restores
at another, or on one device, and back.

Files are written by this module and read back with ``torch.load(...,
weights_only=True)``, which unpickles tensors and plain containers only.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import queue
import re
import shutil
import threading
from pathlib import Path

import torch

from ..parallel.comm import barrier, is_lead
from ..parallel.sharding import gather_params, match_specs, shard_params
from .train_step import TrainState, tree_leaves

logger = logging.getLogger(__name__)

STATE_FILE = "state.pt"


def _to_host(obj):
    """A copy of ``obj`` with every tensor detached and on the CPU, so
    later in-place updates of the live state cannot reach it."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _per_leaf(opt_state: dict, params, specs, fn) -> dict:
    """``opt_state`` with ``fn(tensor, spec)`` applied to every
    per-parameter tensor of its parameter's shape (``params``: the
    leaves whose shapes the tensors have, in the optimizer's order);
    scalars such as AdamW's step count stay as they are."""
    leaves = tree_leaves(params)
    spec_leaves = tree_leaves(match_specs(params, specs))
    state = {}
    for i, per in opt_state["state"].items():
        state[i] = {
            k: fn(v, spec_leaves[i])
            if isinstance(v, torch.Tensor) and v.ndim
            and v.shape == leaves[i].shape else v
            for k, v in per.items()}
    return {**opt_state, "state": state}


def _snapshot(state: TrainState) -> dict | None:
    """The state as whole tensors on the host, or None on a mesh rank
    other than the lead (which writes). On a mesh every rank takes part
    in the gathers."""
    params, opt = state.params, state.optimizer.state_dict()
    if state.mesh is not None:
        opt = _per_leaf(opt, params, state.specs,
                        lambda t, spec: gather_params(t, state.mesh, spec))
        params = gather_params(params, state.mesh, state.specs)
        if not is_lead(state.mesh):
            return None
    return {"params": _to_host(params), "opt_state": _to_host(opt),
            "step": int(state.step)}


def _write(path: Path, snapshot: dict) -> None:
    """Write into ``<path>.tmp`` and rename it to ``path``: a finished
    step directory always holds a whole checkpoint."""
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    torch.save(snapshot, tmp / STATE_FILE)
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def save_train_state(path: str | Path, state: TrainState) -> None:
    """Write ``state`` to the directory ``path``; on a mesh every rank
    calls it and returns once the lead's write is done."""
    path = Path(path).absolute()
    snapshot = _snapshot(state)
    try:
        if snapshot is not None:
            path.parent.mkdir(parents=True, exist_ok=True)
            _write(path, snapshot)
            logger.info("Saved training checkpoint at step %s to %s",
                        int(state.step), path)
    finally:
        if state.mesh is not None:
            barrier(state.mesh)


def restore_train_state(path: str | Path, template: TrainState) -> TrainState:
    """Restore a checkpoint into ``template``: its parameter tensors take
    the saved values in place (keeping their devices and dtypes), its
    optimizer loads the saved state dict. On a mesh each rank takes its
    pieces of the saved whole tensors, cut by the template's mesh and
    specs. Returns a state over the template's tensors and optimizer at
    the saved step."""
    path = Path(path).absolute()
    saved = torch.load(path / STATE_FILE, map_location="cpu",
                       weights_only=True)
    params, opt = saved["params"], saved["opt_state"]
    if template.mesh is not None:
        mesh, specs = template.mesh, template.specs
        opt = _per_leaf(opt, params, specs,
                        lambda t, spec: shard_params(t, mesh, spec))
        params = shard_params(params, mesh, specs)
    dst, src = tree_leaves(template.params), tree_leaves(params)
    if len(dst) != len(src):
        raise ValueError(
            f"{path}: {len(src)} parameter leaves, template has {len(dst)}")
    with torch.no_grad():
        for d, s in zip(dst, src):
            if d.shape != s.shape:
                raise ValueError(
                    f"{path}: leaf of shape {tuple(s.shape)}, template has "
                    f"{tuple(d.shape)}")
            d.copy_(s)
    template.optimizer.load_state_dict(opt)
    logger.info("Restored training checkpoint from %s (step %s)", path,
                saved["step"])
    return dataclasses.replace(template, step=saved["step"])


class _AsyncWriter:
    """One background thread writing checkpoints in the order given."""

    def __init__(self):
        self._queue: "queue.Queue" = queue.Queue()
        self._errors: list[BaseException] = []
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                _write(*item)
            except Exception as e:  # noqa: BLE001 — raised by wait()
                logger.exception("checkpoint write to %s failed", item[0])
                self._errors.append(e)
            finally:
                self._queue.task_done()

    def save(self, path: Path, snapshot: dict) -> None:
        self._queue.put((path, snapshot))

    def wait_until_finished(self) -> None:
        self._queue.join()
        if self._errors:
            raise self._errors.pop(0)

    def close(self) -> None:
        self.wait_until_finished()
        self._queue.put(None)
        self._thread.join()


class AsyncTrainCheckpointer:
    """Non-blocking checkpoint writes for long training runs.

    ``save()`` copies the state to host memory before it returns (later
    steps update the live tensors in place and cannot reach the copy)
    and hands it to a background thread, so the next train steps overlap
    with serialization; a save first waits for the previous write.
    ``wait()`` joins the outstanding write; call it before reading files
    back or exiting. Keeps the newest ``max_to_keep`` step directories.

    ``mesh``: the mesh of the states it saves (states from
    ``make_train_step(mesh=).init``). Every rank of the mesh makes the
    same calls; ``save()`` gathers on every rank and only the mesh's lead
    rank writes, prunes and journals (the other ranks keep the save order
    and the metrics in memory); ``wait()`` ends with a barrier over the mesh,
    so no rank reads a directory the lead is still writing.
    """

    def __init__(self, root: str | Path, max_to_keep: int = 3,
                 keep_best: int = 0, best_mode: str = "min", mesh=None):
        self.root = Path(root).absolute()
        self.root.mkdir(parents=True, exist_ok=True)
        self.mesh = mesh
        self._lead = is_lead(mesh)
        self.max_to_keep = max_to_keep
        # best-k retention: checkpoints whose metric ranks in the top
        # ``keep_best`` (per ``best_mode``: "min" for losses, "max" for
        # accuracies) are never pruned; the metric journal persists in
        # metrics.json so resumes keep the ranking.
        if best_mode not in ("min", "max"):
            raise ValueError(f"best_mode must be min or max, got {best_mode}")
        self.keep_best = keep_best
        self.best_mode = best_mode
        self._metrics_path = self.root / "metrics.json"
        self._metrics: dict[str, float] = {}
        if self._metrics_path.exists():
            try:
                self._metrics = json.loads(self._metrics_path.read_text())
            except ValueError:
                # a crash mid-write left truncated JSON; the journal is
                # an optimization, not ground truth — rebuild empty
                logger.warning(
                    "corrupt %s; best-K ranking resets", self._metrics_path
                )
        self._ckptr = _AsyncWriter()
        # SAVE-ORDER list for recency-based pruning: "newest" means most
        # recently written, NOT numerically highest — after a rollback
        # (restore an earlier step and resume) the fresh low-numbered
        # checkpoints are the ones to keep. Seeded from disk in numeric
        # order (the best available proxy across sessions).
        self._save_order: list[int] = [
            int(p.name.split("_")[1]) for p in self._step_dirs()
        ]
        # drop journal ghosts for checkpoints that no longer exist (they
        # would waste best-K protection slots on deleted dirs)
        on_disk = set(self._save_order)
        stale = [k for k in self._metrics if int(k) not in on_disk]
        for k in stale:
            del self._metrics[k]
        if stale:
            self._write_metrics()

    def step_path(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def _step_dirs(self) -> list[Path]:
        """Finished step directories (not the writer's ``.tmp`` ones)."""
        return sorted(
            p for p in self.root.glob("step_*")
            if re.fullmatch(r"step_\d{8,}", p.name)
        )

    def save(self, state: TrainState, metric: float | None = None) -> Path:
        if state.mesh is not self.mesh:
            raise ValueError(
                "the state's mesh is not the checkpointer's: build the "
                "AsyncTrainCheckpointer with mesh=<the train step's mesh>")
        step = int(state.step)
        path = self.step_path(step)
        if step in self._save_order:
            self._save_order.remove(step)
        self._save_order.append(step)
        if metric is not None:
            self._metrics[str(step)] = float(metric)
            self._write_metrics()
        # the snapshot first: on a mesh its gathers are collectives, made
        # on this thread by every rank
        snapshot = _snapshot(state)
        # One write in flight: the previous one finishes first (as
        # orbax's save does), which bounds host memory to two snapshots.
        # Then prune BEFORE dispatching, so the victim set never holds
        # the write about to start and _gc never joins the writer.
        self._ckptr.wait_until_finished()
        if self._lead:
            self._gc()
        if snapshot is not None:
            self._ckptr.save(path, snapshot)
        logger.info("Async checkpoint started for step %d at %s", step, path)
        return path

    def _write_metrics(self) -> None:
        """Atomic journal write (a crash mid-write must not leave
        truncated JSON that poisons the next session's constructor); the
        lead rank's alone on a mesh."""
        if not self._lead:
            return
        tmp = self._metrics_path.with_suffix(".json.tmp")
        tmp.write_text(json.dumps(self._metrics))
        os.replace(tmp, self._metrics_path)

    def _ranked_best(self) -> list[int]:
        """Step numbers best-first by the journaled metric."""
        sign = 1.0 if self.best_mode == "min" else -1.0
        return [
            int(k)
            for k, _ in sorted(
                self._metrics.items(), key=lambda kv: sign * kv[1]
            )
        ]

    def _gc(self) -> None:
        steps = self._step_dirs()
        protected = set(self._ranked_best()[: self.keep_best])
        if self.max_to_keep > 0:  # [-0:] would protect EVERYTHING
            protected |= set(self._save_order[-self.max_to_keep:])
        victims = [
            p for p in steps if int(p.name.split("_")[1]) not in protected
        ]
        # save() runs this with no write in flight: every step directory
        # is finished (renamed into place after its write)
        journal_dirty = False
        for old in victims:
            shutil.rmtree(old, ignore_errors=True)
            pruned_step = int(old.name.split("_")[1])
            if self._metrics.pop(str(pruned_step), None) is not None:
                journal_dirty = True
            if pruned_step in self._save_order:
                self._save_order.remove(pruned_step)
            logger.info("Pruned old checkpoint %s", old)
        if journal_dirty:
            # a stale entry for a deleted checkpoint would count against
            # the next session's best-K protection
            self._write_metrics()

    def best(self) -> Path | None:
        """Path of the best-metric checkpoint still on disk."""
        self.wait()
        for step in self._ranked_best():
            p = self.step_path(step)
            if p.exists():
                return p
        return None

    def restore_best(self, template: TrainState) -> TrainState:
        path = self.best()
        if path is None:
            raise FileNotFoundError(
                f"no metric-journaled checkpoints under {self.root}"
            )
        return restore_train_state(path, template)

    def wait(self) -> None:
        try:
            self._ckptr.wait_until_finished()
        finally:
            if self.mesh is not None:
                barrier(self.mesh)

    def latest(self) -> Path | None:
        self.wait()
        steps = self._step_dirs()
        return steps[-1] if steps else None

    def restore_latest(self, template: TrainState) -> TrainState:
        path = self.latest()
        if path is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        return restore_train_state(path, template)

    def close(self) -> None:
        try:
            self._ckptr.close()
        finally:
            if self.mesh is not None:
                barrier(self.mesh)
