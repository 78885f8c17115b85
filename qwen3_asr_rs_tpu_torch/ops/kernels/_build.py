"""Build and bind the CUDA kernels of ``qwen3_asr_rs_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` compiles with nvcc into its own shared library
with a plain C interface, at first use, into ``build/kernels/`` at the
repository root (listed in ``.gitignore``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v -o build/kernels/lib<name>-<hash>.so \\
         csrc/<name>.cu

The file name carries a hash of the sources and flags, so an edited
kernel is never served from a stale library. The libraries are loaded
with ``ctypes``; every pointer and the CUDA stream pass as
``ctypes.c_void_p``, and every C entry returns ``cudaGetLastError()``
after its launches, which ``check`` turns into an exception. Nothing
here runs at import: the CPU-only test suite imports every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNEL_SOURCES = ("decode_attention", "decode_layer", "flash_attention",
                  "gumbel_argmax", "moe_experts", "quant_matmul",
                  "quant_matvec_int4")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or $PATH; raises if absent."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.exists():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the CUDA kernels are built "
            "from source at first use"
        )
    return found


def library_path(name: str) -> Path:
    """Where ``csrc/<name>.cu`` builds to, keyed by a hash of every
    source it can include and of the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + [CSRC_DIR / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNEL_SOURCES) -> dict[str, float]:
    """Compile the named kernels that are not built yet, in parallel.

    Returns {name: seconds} for the ones compiled now. The ptxas report
    (registers, shared memory, spills) lands in ``build/kernels/<name>.log``.
    Raises RuntimeError with nvcc's output when a build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    t0 = time.monotonic()
    for n in todo:
        out = library_path(n)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out)
    seconds, failed = {}, []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        seconds[n] = time.monotonic() - t0
        (BUILD_DIR / f"{n}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode})\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)  # atomic: a concurrent process never loads a partial .so
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The built library for ``csrc/<name>.cu``, compiling it if needed."""
    with _lock:
        if name not in _libs:
            path = library_path(name)
            if not path.exists():
                build([name])
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def bind(lib: ctypes.CDLL, fn: str, n_ptr: int, scalars: tuple) -> None:
    """Declare ``fn(n_ptr pointers..., *scalars, stream) -> int``."""
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_void_p] * n_ptr + list(scalars) + [ctypes.c_void_p]
    f.restype = ctypes.c_int


def stream_of(t) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``t``'s device."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def check_not_frozen(what: str, value) -> None:
    """Raise if a host int would be frozen into a CUDA graph: while the
    current stream is capturing, a bound such as a decode step's ``end``
    must be a device tensor, which the graph's replays read afresh."""
    import torch

    if not isinstance(value, torch.Tensor) and (
            torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        raise ValueError(
            f"{what}: a host int is frozen into a captured CUDA graph; "
            "pass a device tensor")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a C entry returned a CUDA error code."""
    if rc != 0:
        lib.cuda_error_string.restype = ctypes.c_char_p
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
