# A copy of qwen3_asr_rs_tpu/audio/native.py: the port keeps its own, so that it imports nothing of the JAX package.
"""ctypes binding for the native C++ audio decoder (native/audioio.cpp).

The shared library is built with ``make -C native`` and searched for next
to the repo root and in this package. All entry points degrade gracefully:
callers fall back to the numpy path when the library is missing.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

_lock = threading.Lock()
_lib = None
_lib_checked = False


def _find_library() -> Path | None:
    here = Path(__file__).resolve()
    candidates = [
        here.parent.parent.parent / "native" / "libaudioio.so",
        here.parent / "libaudioio.so",
    ]
    for c in candidates:
        if c.exists():
            return c
    return None


def _load():
    global _lib, _lib_checked
    with _lock:
        if _lib_checked:
            return _lib
        _lib_checked = True
        path = _find_library()
        if path is None:
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError:
            return None
        lib.audioio_load_wav.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.audioio_load_wav.restype = ctypes.c_int64
        lib.audioio_copy.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
        ]
        lib.audioio_copy.restype = None
        lib.audioio_error.restype = ctypes.c_char_p
        lib.audioio_resample.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.audioio_resample.restype = ctypes.c_int64
        # library-level FFmpeg decode (native/avdecode.cpp) — present
        # only when the libav dev headers existed at build time
        if hasattr(lib, "avdec_load"):
            lib.avdec_load.argtypes = [ctypes.c_char_p, ctypes.c_int]
            lib.avdec_load.restype = ctypes.c_int64
            lib.avdec_copy.argtypes = [
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
            ]
            lib.avdec_copy.restype = None
            lib.avdec_error.restype = ctypes.c_char_p
            lib.avdec_encode_test.argtypes = [
                ctypes.c_char_p,
                ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64,
                ctypes.c_int,
            ]
            lib.avdec_encode_test.restype = ctypes.c_int
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load() is not None


def _copy_out(lib, n: int, copy_fn, err_fn, what: str) -> np.ndarray:
    """Shared result/error handling for the decoder entry points."""
    if n <= 0:
        raise RuntimeError(f"{what} failed: {err_fn().decode()}")
    out = np.empty(n, dtype=np.float32)
    copy_fn(out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n)
    return out


def native_load_wav(path: str, target_rate: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native audioio library not built")
    n = lib.audioio_load_wav(path.encode(), target_rate)
    return _copy_out(lib, n, lib.audioio_copy, lib.audioio_error,
                     "native WAV decode")


def native_any_available() -> bool:
    """True when the libav decode shim was compiled in."""
    lib = _load()
    return lib is not None and hasattr(lib, "avdec_load")


def native_load_any(path: str, target_rate: int) -> np.ndarray:
    """Decode ANY container/codec via the libav shim (no ffmpeg binary)."""
    lib = _load()
    if lib is None or not hasattr(lib, "avdec_load"):
        raise RuntimeError("native libav decoder not built")
    n = lib.avdec_load(path.encode(), target_rate)
    return _copy_out(lib, n, lib.avdec_copy, lib.avdec_error,
                     "native libav decode")


def native_encode_test(path: str, samples: np.ndarray, rate: int) -> None:
    """Test helper: encode mono f32 to `path` (format from extension)."""
    lib = _load()
    if lib is None or not hasattr(lib, "avdec_encode_test"):
        raise RuntimeError("native libav encoder not built")
    x = np.ascontiguousarray(samples, dtype=np.float32)
    ok = lib.avdec_encode_test(
        path.encode(),
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        len(x),
        rate,
    )
    if not ok:
        raise RuntimeError(
            f"native encode failed: {lib.avdec_error().decode()}"
        )


def native_resample(samples: np.ndarray, from_rate: int, to_rate: int):
    lib = _load()
    if lib is None:
        raise RuntimeError("native audioio library not built")
    x = np.ascontiguousarray(samples, dtype=np.float64)
    n = lib.audioio_resample(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(x), from_rate, to_rate,
    )
    return _copy_out(lib, n, lib.audioio_copy, lib.audioio_error,
                     "native resample")
