# A copy of qwen3_asr_rs_tpu/audio/load.py: the port keeps its own, so that it imports nothing of the JAX package.
"""Audio loading: any format -> mono float32 at the target sample rate.

Fallback chain mirroring the reference's (src/audio.rs:7-15):
  1. native C++ decoders (``native/``) when built: WAV goes through the
     bespoke parser + polyphase sinc resampler (the analog of the
     reference's hound+rubato path, bit-matched to the numpy oracle);
     other containers go through the libav shim (``avdecode.cpp``) —
     library-level FFmpeg decode exactly like the reference's primary
     path (src/audio.rs:18-132), no ffmpeg binary needed;
  2. ffmpeg CLI (any container/codec) when an ffmpeg binary is on PATH;
  3. pure-numpy WAV reader + polyphase sinc resampler (always available).
"""

from __future__ import annotations

import logging
import shutil
import struct
import subprocess
from pathlib import Path

import numpy as np

from .resample import resample_sinc

logger = logging.getLogger(__name__)


def sniff_format(path: str) -> str | None:
    """Identify a container by magic bytes (for actionable errors)."""
    try:
        with open(path, "rb") as f:
            head = f.read(12)
    except OSError:
        return None
    if len(head) < 4:
        return None
    if head[:4] == b"RIFF" and head[8:12] == b"WAVE":
        return "wav"
    if head[:4] == b"fLaC":
        return "flac"
    if head[:4] == b"OggS":
        return "ogg"
    if head[:3] == b"ID3" or head[:2] in (b"\xff\xfb", b"\xff\xf3",
                                          b"\xff\xf2", b"\xff\xfa"):
        return "mp3"
    if head[4:8] == b"ftyp":
        return "m4a"
    return None


def load_audio(path: str | Path, target_sample_rate: int = 16000) -> np.ndarray:
    """Load an audio file as mono f32 at ``target_sample_rate``."""
    path = str(path)
    errors = []

    try:
        from .native import (
            native_any_available,
            native_available,
            native_load_any,
            native_load_wav,
        )

        fmt = sniff_format(path)
        if fmt != "wav" and native_any_available():
            # non-WAV: library-level FFmpeg decode (no binary needed)
            samples = native_load_any(path, target_sample_rate)
            logger.info(
                "Loaded audio via native libav decoder: %d samples "
                "(%.2fs at %dHz)",
                len(samples), len(samples) / target_sample_rate,
                target_sample_rate,
            )
            return samples
        if native_available():
            samples = native_load_wav(path, target_sample_rate)
            logger.info(
                "Loaded audio via native decoder: %d samples (%.2fs at %dHz)",
                len(samples), len(samples) / target_sample_rate,
                target_sample_rate,
            )
            return samples
    except Exception as e:  # noqa: BLE001 - fall through the chain
        errors.append(f"native: {e}")

    try:
        samples = load_audio_ffmpeg(path, target_sample_rate)
        logger.info(
            "Loaded audio via ffmpeg: %d samples (%.2fs at %dHz)",
            len(samples), len(samples) / target_sample_rate, target_sample_rate,
        )
        return samples
    except Exception as e:  # noqa: BLE001
        errors.append(f"ffmpeg: {e}")

    try:
        samples = load_audio_wav(path, target_sample_rate)
        logger.info(
            "Loaded audio via WAV reader: %d samples (%.2fs at %dHz)",
            len(samples), len(samples) / target_sample_rate, target_sample_rate,
        )
        return samples
    except Exception as e:  # noqa: BLE001
        errors.append(f"wav: {e}")

    from ..errors import AudioError

    from .native import native_any_available

    fmt = sniff_format(path)
    if (
        fmt is not None
        and fmt != "wav"
        and shutil.which("ffmpeg") is None
        and not native_any_available()
    ):
        # non-WAV needs either the compiled libav shim (build with
        # `make -C native` where libav dev headers exist) or an ffmpeg
        # binary; the reference links libav directly (src/audio.rs:18-132)
        raise AudioError(
            f"{path} is a {fmt.upper()} file, but neither the native "
            f"libav decoder nor an ffmpeg binary is available. Install "
            f"ffmpeg (e.g. `apt install ffmpeg`), rebuild the native "
            f"library against libav, or convert the file to WAV first. "
            f"Decode attempts: {'; '.join(errors)}"
        )
    raise AudioError(
        f"Could not decode audio file {path}; attempts: {'; '.join(errors)}"
    )


def load_audio_ffmpeg(path: str, target_sample_rate: int) -> np.ndarray:
    """Decode any format via the ffmpeg CLI to raw mono f32le."""
    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is None:
        raise FileNotFoundError("no ffmpeg binary on PATH")
    proc = subprocess.run(
        [
            ffmpeg, "-v", "error", "-i", path,
            "-f", "f32le", "-ac", "1", "-ar", str(target_sample_rate), "-",
        ],
        capture_output=True,
        check=True,
    )
    samples = np.frombuffer(proc.stdout, dtype=np.float32)
    if samples.size == 0:
        raise ValueError("ffmpeg produced no samples")
    return samples


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Minimal RIFF/WAVE reader: PCM 8/16/24/32-bit and float 32/64.

    Returns (samples (n, channels) float64 in [-1, 1], sample_rate).
    """
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 12 or data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError("not a RIFF/WAVE file")

    fmt = None
    fmt_body = b""
    payload = None
    off = 12
    while off + 8 <= len(data):
        chunk_id = data[off : off + 4]
        (size,) = struct.unpack_from("<I", data, off + 4)
        body = data[off + 8 : off + 8 + size]
        if chunk_id == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            fmt_body = body
        elif chunk_id == b"data":
            payload = body
        off += 8 + size + (size & 1)

    if fmt is None or payload is None:
        raise ValueError("missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE
        # The subformat GUID (fmt-chunk offset 24) carries the real format
        # tag in its first two bytes (1 = PCM, 3 = IEEE float).
        if len(fmt_body) >= 26:
            (audio_format,) = struct.unpack_from("<H", fmt_body, 24)
        else:  # malformed: no GUID present; guess (same rule as audioio.cpp)
            audio_format = 3 if bits in (32, 64) else 1

    if audio_format == 1:  # PCM
        if bits == 8:
            x = data_to_float(np.frombuffer(payload, np.uint8).astype(np.float64)
                              - 128.0, 1 << 7)
        elif bits == 16:
            x = data_to_float(np.frombuffer(payload, "<i2"), 1 << 15)
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            vals = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
            x = data_to_float(vals, 1 << 23)
        elif bits == 32:
            x = data_to_float(np.frombuffer(payload, "<i4"), 1 << 31)
        else:
            raise ValueError(f"unsupported PCM bit depth {bits}")
    elif audio_format == 3:  # IEEE float
        if bits == 32:
            x = np.frombuffer(payload, "<f4").astype(np.float64)
        elif bits == 64:
            x = np.frombuffer(payload, "<f8").astype(np.float64)
        else:
            raise ValueError(f"unsupported float bit depth {bits}")
    else:
        raise ValueError(f"unsupported WAV format tag {audio_format}")

    n = (len(x) // channels) * channels
    return x[:n].reshape(-1, channels), sample_rate


def data_to_float(x: np.ndarray, scale: int) -> np.ndarray:
    return np.asarray(x, dtype=np.float64) / float(scale)


def load_audio_wav(path: str, target_sample_rate: int) -> np.ndarray:
    """WAV -> mono mixdown -> sinc resample (src/audio.rs:162-217 analog)."""
    frames, rate = read_wav(path)
    mono = frames.mean(axis=1)
    if rate != target_sample_rate:
        return resample_sinc(mono, rate, target_sample_rate)
    return mono.astype(np.float32)
