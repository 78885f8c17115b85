"""Hand-written CUDA kernels (``csrc/``) and their plain PyTorch versions.

Each module holds one kernel's wrapper, its plain PyTorch version and
its launch counter. A wrapper given CPU tensors runs the plain version;
given CUDA tensors it launches the kernel or raises. Nothing is built or
loaded until a CUDA tensor reaches a wrapper.
"""
