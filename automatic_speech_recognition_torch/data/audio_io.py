"""The port's own copy of automatic_speech_recognition_tpu/data/audio_io.py
(tests/test_torch_shared_copies.py holds it to the original).

Audio file IO.

The reference decodes FLAC through soundfile/libsndfile (preprocess.py:9,
:69).  This environment has neither, so the framework carries its own
decoders:

- WAV: pure NumPy PCM16/24/32 + float32 reader/writer (this module).
- FLAC: native C++ decoder (native/flacdec.cpp) loaded via ctypes when
  built; see data/flac.py.

Like soundfile, readers return float64 in [-1, 1) and the sample rate.
"""

from __future__ import annotations

import os
import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Read a PCM/float WAV file -> (float64 mono signal, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"not a WAV file: {path}")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + size]
        if len(body) < size:
            # fail loudly on truncation instead of decoding clipped audio
            # (the FLAC path errors on short files the same way)
            raise ValueError(
                f"truncated WAV: chunk {cid!r} declares {size} bytes but "
                f"only {len(body)} remain ({path})")
        if cid == b"fmt ":
            if len(body) < 16:
                raise ValueError(f"malformed WAV: short fmt chunk ({path})")
            fmt = struct.unpack("<HHIIHH", body[:16])
        elif cid == b"data":
            raw = body
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise ValueError(f"malformed WAV: {path}")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 1:  # PCM
        if bits == 16:
            sig = np.frombuffer(raw, "<i2").astype(np.float64) / 32768.0
        elif bits == 32:
            sig = np.frombuffer(raw, "<i4").astype(np.float64) / 2147483648.0
        elif bits == 24:
            b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
            val = (b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8)
                   | (b[:, 2].astype(np.int32) << 16))
            val = np.where(val >= 1 << 23, val - (1 << 24), val)
            sig = val.astype(np.float64) / float(1 << 23)
        elif bits == 8:
            sig = (np.frombuffer(raw, np.uint8).astype(np.float64) - 128.0) / 128.0
        else:
            raise ValueError(f"unsupported PCM bits: {bits}")
    elif audio_format == 3:  # IEEE float
        sig = np.frombuffer(raw, "<f4" if bits == 32 else "<f8").astype(np.float64)
    else:
        raise ValueError(f"unsupported WAV format code: {audio_format}")
    if channels > 1:
        sig = sig.reshape(-1, channels).mean(axis=1)
    return sig, sample_rate


def write_wav(path: str, signal: np.ndarray, sample_rate: int) -> None:
    """Write mono float signal in [-1, 1] as PCM16 WAV."""
    sig = np.clip(np.asarray(signal, np.float64), -1.0, 1.0)
    pcm = np.round(sig * 32767.0).astype("<i2").tobytes()
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<IHHIIHH", 16, 1, 1, sample_rate,
                                      sample_rate * 2, 2, 16))
        f.write(b"data" + struct.pack("<I", len(pcm)) + pcm)


def read_audio(path: str) -> Tuple[np.ndarray, int]:
    """Dispatch by extension; FLAC uses the native decoder when available."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        return read_wav(path)
    if ext == ".flac":
        from . import flac
        return flac.read_flac(path)
    raise ValueError(f"unsupported audio format: {path}")
