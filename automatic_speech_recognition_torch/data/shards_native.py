"""The port's own copy of automatic_speech_recognition_tpu/data/shards_native.py
(tests/test_torch_shared_copies.py holds it to the original).

ctypes binding for the native ARSH shard reader (native/shardio.cpp).

Mirrors data/shards.ShardReader's record() contract; `available()` gates
use so the pure-Python reader remains the always-working fallback.
The batch assembly path (`read_into`) copies a record straight from the
mmap into a caller-owned padded batch row — one memcpy per record, no
intermediate arrays.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from ._native import load_native


def _configure(lib: ctypes.CDLL) -> None:
    lib.shard_open.restype = ctypes.c_void_p
    lib.shard_open.argtypes = [ctypes.c_char_p]
    lib.shard_close.argtypes = [ctypes.c_void_p]
    lib.shard_num_records.restype = ctypes.c_int64
    lib.shard_num_records.argtypes = [ctypes.c_void_p]
    for f in (lib.shard_feat_dim, lib.shard_channels):
        f.restype = ctypes.c_int32
        f.argtypes = [ctypes.c_void_p]
    for f in (lib.shard_featlen, lib.shard_tokenlen):
        f.restype = ctypes.c_int32
        f.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.shard_read_into.restype = ctypes.c_int
    lib.shard_read_into.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]


def _load() -> Optional[ctypes.CDLL]:
    return load_native("libshardio.so", _configure)


def available() -> bool:
    return _load() is not None


class NativeShardReader:
    """Same record() contract as shards.ShardReader, native backend."""

    def __init__(self, path: str):
        lib = _load()
        if lib is None:
            raise RuntimeError("native shardio not available")
        self._lib = lib
        self._h = lib.shard_open(path.encode())
        if not self._h:
            raise ValueError(f"bad shard: {path}")
        self.path = path
        self.num_records = int(lib.shard_num_records(self._h))
        self.feat_dim = int(lib.shard_feat_dim(self._h))
        self.channels = int(lib.shard_channels(self._h))

    def __len__(self) -> int:
        return self.num_records

    def _handle(self):
        # ValueError (matching the pure-Python reader's misuse behavior)
        # instead of passing NULL into C, which would segfault
        if self._h is None:
            raise ValueError(f"reader is closed ({self.path})")
        return self._h

    def featlen(self, i: int) -> int:
        return int(self._lib.shard_featlen(self._handle(), i))

    def tokenlen(self, i: int) -> int:
        return int(self._lib.shard_tokenlen(self._handle(), i))

    def read_into(self, i: int, feat_row: np.ndarray,
                  tok_row: np.ndarray) -> Tuple[int, int]:
        """Copy record i into pre-zeroed (T_pad, D, C) float32 and (L_pad,)
        int32 rows; returns (T, L) actually written."""
        if feat_row.shape[1:] != (self.feat_dim, self.channels):
            # the C memcpy uses the SHARD's stride; a mismatched buffer
            # would be silently corrupted
            raise ValueError(
                f"destination row {feat_row.shape[1:]} != shard geometry "
                f"({self.feat_dim}, {self.channels})")
        # the C side writes raw bytes through the ctypes data pointer, so
        # dtype and layout must match exactly too (a float64 or strided
        # destination would pass the shape check and fill with garbage)
        if feat_row.dtype != np.float32 or not feat_row.flags.c_contiguous:
            raise ValueError(
                f"feat destination must be C-contiguous float32, got "
                f"{feat_row.dtype}, contiguous={feat_row.flags.c_contiguous}")
        if tok_row.dtype != np.int32 or not tok_row.flags.c_contiguous:
            raise ValueError(
                f"token destination must be C-contiguous int32, got "
                f"{tok_row.dtype}, contiguous={tok_row.flags.c_contiguous}")
        T = ctypes.c_int32()
        L = ctypes.c_int32()
        rc = self._lib.shard_read_into(
            self._handle(), i,
            feat_row.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            feat_row.shape[0],
            tok_row.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            tok_row.shape[0], ctypes.byref(T), ctypes.byref(L))
        if rc != 0:
            raise ValueError(f"shard_read_into failed rc={rc} ({self.path})")
        return T.value, L.value

    def record(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        T = self.featlen(i)
        L = self.tokenlen(i)
        feat = np.zeros((T, self.feat_dim, self.channels), np.float32)
        tok = np.zeros((L,), np.int32)
        self.read_into(i, feat, tok)
        return feat, tok

    def close(self):
        if self._h:
            self._lib.shard_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
