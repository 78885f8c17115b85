"""Multi-device execution: a (dp, tp) ``DeviceMesh`` over
``torch.distributed``, the Megatron spec trees and placement, and the
tensor-parallel collectives the models insert (``comm.py``)."""

from .mesh import make_mesh, mesh_shape
from .sharding import (
    P,
    decoder_param_specs,
    encoder_param_specs,
    gather_params,
    int4_decoder_param_specs,
    match_specs,
    model_param_specs,
    named_shardings,
    quantized_decoder_param_specs,
    shard_params,
)

__all__ = [
    "make_mesh",
    "decoder_param_specs",
    "encoder_param_specs",
    "shard_params",
    "P",
    "int4_decoder_param_specs",
    "match_specs",
    "mesh_shape",
    "named_shardings",
    "quantized_decoder_param_specs",
    "gather_params",
    "model_param_specs",
]
