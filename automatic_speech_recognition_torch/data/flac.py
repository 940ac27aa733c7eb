"""The port's own copy of automatic_speech_recognition_tpu/data/flac.py
(tests/test_torch_shared_copies.py holds it to the original).

FLAC decoding via the native C++ decoder (native/flacdec.cpp).

The reference reads FLAC through soundfile/libsndfile (reference
preprocess.py:9, :69); this wrapper exposes the framework's own decoder
with the same contract as read_wav: float64 mono signal in [-1, 1) plus
the sample rate.  The shared library is built on first use (data/_native).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from ._native import load_native


def _configure(lib: ctypes.CDLL) -> None:
    lib.flac_decode.restype = ctypes.c_int
    lib.flac_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.flac_free.argtypes = [ctypes.POINTER(ctypes.c_int32)]


def read_flac(path: str) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (float64 mono signal in [-1, 1), sample_rate)."""
    lib = load_native("libflacdec.so", _configure)
    if lib is None:
        raise RuntimeError("native FLAC decoder unavailable (no toolchain)")
    with open(path, "rb") as f:
        data = f.read()
    samples = ctypes.POINTER(ctypes.c_int32)()
    n = ctypes.c_int64()
    rate = ctypes.c_int()
    channels = ctypes.c_int()
    bps = ctypes.c_int()
    rc = lib.flac_decode(data, len(data), ctypes.byref(samples),
                         ctypes.byref(n), ctypes.byref(rate),
                         ctypes.byref(channels), ctypes.byref(bps))
    if rc != 0:
        raise ValueError(f"FLAC decode failed (code {rc}): {path}")
    try:
        count = n.value * channels.value
        # one copy: detach from the C buffer and convert in one astype
        sig = np.ctypeslib.as_array(samples, shape=(count,)).astype(np.float64)
    finally:
        lib.flac_free(samples)
    sig /= float(1 << (bps.value - 1))
    if channels.value > 1:
        sig = sig.reshape(-1, channels.value).mean(axis=1)
    return sig, rate.value
