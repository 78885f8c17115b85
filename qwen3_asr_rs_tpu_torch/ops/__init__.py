"""Tensor ops: norms, rotary embeddings, attention; CUDA kernels in ``kernels``."""
