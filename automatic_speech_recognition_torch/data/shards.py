"""The port's own copy of automatic_speech_recognition_tpu/data/shards.py
(tests/test_torch_shared_copies.py holds it to the original).

ARSH shard container: the TFRecord/protobuf replacement.

The reference serializes (flattened float feat, int64 shape, int64 tokens)
Examples into TFRecord shards of ~5000 records with shuffling and a
1710-frame length cut (create_tfrecord.py:44-95, :28-29, :129-137).

ARSH is a simple packed binary format designed for memory-mapped, zero-copy
reads on the host datapath:

    header : magic 'ARSH' | u32 version | u64 num_records
             u32 feat_dim | u32 channels | u64 index_offset
    records: per record  u32 T | u32 n_tokens | f32 feat[T*D*C] | i32 tokens
    index  : u64 byte offset of each record (enables O(1) random access,
             which TFRecord cannot do)

Readers return NumPy views into the mmap — no copies until batching pads.
A native C++ reader with the same layout backs the hot path when built
(native/shardio.cpp); this module is the always-available implementation
and the format owner.
"""

from __future__ import annotations

import mmap
import os
import struct
from dataclasses import dataclass
from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ..utils.numerics import cdiv

MAGIC = b"ARSH"
VERSION = 1
_HDR = struct.Struct("<4sIQ IIQ")


def write_shard(path: str, feats: Sequence[np.ndarray],
                tokens: Sequence[Sequence[int]]) -> int:
    """Write one shard; feats[i] is (T, D, C) float32 (or (T, D))."""
    assert len(feats) == len(tokens)
    if len(feats):
        f0 = np.asarray(feats[0])
        D = f0.shape[1]
        C = f0.shape[2] if f0.ndim == 3 else 1
        for k, f in enumerate(feats):  # uniform stride or readers corrupt
            fs = np.asarray(f).shape
            if fs[1] != D or (fs[2] if len(fs) == 3 else 1) != C:
                raise ValueError(
                    f"record {k} geometry {fs[1:]} != shard ({D}, {C})")
    else:
        D = C = 0
    offsets: List[int] = []
    with open(path, "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, len(feats), D, C, 0))
        for feat, tok in zip(feats, tokens):
            feat = np.ascontiguousarray(feat, np.float32)
            tok = np.ascontiguousarray(tok, np.int32)
            offsets.append(f.tell())
            f.write(struct.pack("<II", feat.shape[0], tok.shape[0]))
            f.write(feat.tobytes())
            f.write(tok.tobytes())
        index_offset = f.tell()
        f.write(np.asarray(offsets, "<u8").tobytes())
        f.seek(0)
        f.write(_HDR.pack(MAGIC, VERSION, len(feats), D, C, index_offset))
    return len(feats)


@dataclass
class ShardReader:
    """Memory-mapped random-access reader for one ARSH shard."""

    path: str

    def __post_init__(self):
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        magic, ver, n, D, C, idx_off = _HDR.unpack_from(self._mm, 0)
        if magic != MAGIC:
            raise ValueError(f"bad shard magic in {self.path}")
        self.num_records, self.feat_dim, self.channels = n, D, C
        self._offsets = np.frombuffer(self._mm, "<u8", count=n, offset=idx_off)

    def __len__(self) -> int:
        return self.num_records

    def record(self, i: int) -> Tuple[np.ndarray, np.ndarray]:
        """Return (feat (T, D, C) float32 view, tokens (L,) int32 view)."""
        off = int(self._offsets[i])
        T, L = struct.unpack_from("<II", self._mm, off)
        D, C = self.feat_dim, self.channels
        feat = np.frombuffer(self._mm, "<f4", count=T * D * C, offset=off + 8)
        tok = np.frombuffer(self._mm, "<i4", count=L,
                            offset=off + 8 + 4 * T * D * C)
        return feat.reshape(T, D, C), tok

    def featlen(self, i: int) -> int:
        return struct.unpack_from("<I", self._mm, int(self._offsets[i]))[0]

    def tokenlen(self, i: int) -> int:
        return struct.unpack_from("<I", self._mm, int(self._offsets[i]) + 4)[0]

    def close(self):
        self._mm.close()
        self._f.close()


def get_num_records(files: Iterable[str]) -> int:
    """Total records across shards (reference: tfrecord_data_loader.py:17-22 —
    but O(1) per shard here thanks to the header)."""
    total = 0
    for fn in files:
        with open(fn, "rb") as f:
            hdr = f.read(_HDR.size)
        total += _HDR.unpack(hdr)[2]
    return total


def create_shards(feats: Sequence[np.ndarray], tokens: Sequence[Sequence[int]],
                  prefix: str, records_per_shard: int = 5000,
                  maxlen: Optional[int] = None, shuffle: bool = True,
                  seed: int = 0, start_index: int = 1) -> List[str]:
    """Shuffle, drop featlen >= maxlen, split into numbered shards
    (create_tfrecord.py semantics: MAXLEN cut :136-137, shuffle :130-133,
    ~5000 records/shard :29)."""
    n = len(feats)
    order = np.arange(n)
    if shuffle:
        order = np.random.default_rng(seed).permutation(n)
    keep = [i for i in order
            if maxlen is None or len(feats[i]) < maxlen]
    paths = []
    # ceil: no shard may exceed the per-shard target (floor left shards of
    # up to 2*records_per_shard-1 records, e.g. 9,999 in one "5k" shard);
    # the remainder spreads one record each over the first shards so the
    # cap holds for any target size
    num_files = max(1, cdiv(len(keep), records_per_shard))
    per, rem = divmod(len(keep), num_files)
    lo = 0
    for s in range(num_files):
        hi = lo + per + (1 if s < rem else 0)
        idx = keep[lo:hi]
        lo = hi
        path = f"{prefix}-{s + start_index}.arsh"
        write_shard(path, [feats[i] for i in idx], [tokens[i] for i in idx])
        paths.append(path)
    return paths
