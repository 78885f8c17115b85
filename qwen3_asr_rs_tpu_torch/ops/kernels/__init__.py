"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain PyTorch version and
its launch counter. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel or raises. Nothing is built or
loaded until a CUDA tensor reaches a wrapper.

``COUNTED`` holds every launch counter, registered (``counted``) where
its module defines it; ``runtime/cuda_graph.py`` adds a captured graph's
launches to them on every replay.
"""

import torch

COUNTED = []


def counted(wrapper):
    """Give ``wrapper`` a ``launches`` counter at 0 and register it in
    ``COUNTED`` (a decorator); returns it."""
    wrapper.launches = 0
    COUNTED.append(wrapper)
    return wrapper


def forbid_backward(kernel: str, *tensors) -> None:
    """Raise if autograd would need a gradient through ``kernel``: a
    launch returns tensors outside the graph, so differentiating through
    it would silently detach everything before it. The plain versions
    raise too, so that the CPU behaves as the card does."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel} has no backward: run it under torch.no_grad() or "
            "train on float weights at a size that takes the dense path"
        )
