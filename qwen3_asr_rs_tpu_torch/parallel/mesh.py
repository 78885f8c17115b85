"""Device mesh construction over ``torch.distributed``.

Port of ``qwen3_asr_rs_tpu/parallel/mesh.py``: a ('dp', 'tp') mesh. Data
parallelism shards utterance batches, serving slots and training rows;
tensor parallelism shards the decoder's attention heads and MLP width
(Megatron layout, ``parallel/sharding.py``), with the collectives inserted
by hand (``parallel/comm.py``): PyTorch has no GSPMD.

The program is SPMD: every rank of the process group builds the same mesh,
the same engine from the same full weights, and calls the same entry point
with the same inputs. The caller initialises the process group (torchrun's
environment, or ``init_process_group`` with an address, a world size and a
rank); the mesh's ranks are the first ``n_devices`` of it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

MESH_DIMS = ("dp", "tp")


def mesh_shape(n: int, dp: Optional[int] = None, tp: Optional[int] = None,
               tp_divisor_of: int = 8) -> tuple[int, int]:
    """(dp, tp) for ``n`` devices, by the JAX rule: without dp and tp, tp
    takes the largest power of two that divides both ``n`` and
    ``tp_divisor_of`` (the KV-head count: tp must divide it for clean head
    sharding) and dp the rest; with one of them given, the other takes the
    rest. Raises ValueError when dp * tp != n."""
    if tp is None and dp is None:
        tp = 1
        while (tp * 2 <= n and n % (tp * 2) == 0
               and tp_divisor_of % (tp * 2) == 0):
            tp *= 2
        dp = n // tp
    elif tp is None:
        tp = n // dp
    elif dp is None:
        dp = n // tp
    if dp * tp != n:
        raise ValueError(f"dp({dp}) * tp({tp}) != devices({n})")
    return dp, tp


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              tp: Optional[int] = None, device_type: str = "cuda",
              tp_divisor_of: int = 8):
    """A ('dp', 'tp') ``DeviceMesh`` over ranks [0, n_devices) of the
    initialised process group (default: all of them), shaped by
    ``mesh_shape``. Rank r sits at (r // tp, r % tp): a tp group is tp
    consecutive ranks. Every rank of the group calls this (it creates the
    sub-groups); a rank outside the mesh gets a mesh whose
    ``get_coordinate()`` is None. ``device_type``: "cuda" (NCCL, or gloo
    for ranks that share a card) or "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh: initialise the process group first "
            "(torch.distributed.init_process_group, or torchrun)")
    n = dist.get_world_size() if n_devices is None else n_devices
    shape = mesh_shape(n, dp, tp, tp_divisor_of)
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh(device_type, torch.arange(n).reshape(shape),
                      mesh_dim_names=MESH_DIMS)


def mesh_dims(mesh) -> tuple[int, int]:
    """(dp, tp) of a mesh; (1, 1) for None. Raises TypeError for anything
    but a ('dp', 'tp') DeviceMesh."""
    if mesh is None:
        return 1, 1
    if tuple(getattr(mesh, "mesh_dim_names", None) or ()) != MESH_DIMS:
        raise TypeError(
            f"mesh must be a ('dp', 'tp') torch DeviceMesh (make_mesh), got "
            f"{type(mesh).__name__}")
    return mesh.size(0), mesh.size(1)
