"""Pack preprocessed features into ARSH shards (counterpart of the
repository's create_shards.py, on the same flags; host only).

    python -m automatic_speech_recognition_torch.create_shards \\
        <create_shards.py's flags>

Reads preprocess's output in --feat_dir ({cat}-feats[-i].npy object arrays
and {cat}-{unit}s.npy token ids, as either package's preprocess writes
them), shuffles the training sets with --seed, drops training utterances
with featlen >= --maxlen (in samples for --audio_shards: maxlen * fstride
+ flen, so the same utterances go), and writes --records_per_shard-record
shards into --shard_dir:

  train-1.arsh ... train-N.arsh      (every train-{100,360,500} and
                                      speed-augmented set)
  dev-1.arsh / test-1.arsh           (in order, no length cut)

The same dumps give byte-identical shards from either package.

Tiny run:
  python -m automatic_speech_recognition_torch.create_shards --unit char \\
      --feat_dir /tmp/feats --shard_dir /tmp/shards
"""

from __future__ import annotations

import glob as globlib
import logging
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from automatic_speech_recognition_torch.config import parse_args
from automatic_speech_recognition_torch.data import shards
from automatic_speech_recognition_torch.ops.frontend_host import frame_params

log = logging.getLogger("create_shards")


def load_cat_feats(feat_dir: str, cat: str) -> List[np.ndarray]:
    """One category's features: a single file or numbered parts."""
    single = os.path.join(feat_dir, f"{cat}-feats.npy")
    if os.path.exists(single):
        return list(np.load(single, allow_pickle=True))
    parts = sorted(globlib.glob(os.path.join(feat_dir, f"{cat}-feats-*.npy")),
                   key=lambda p: int(p.rsplit("-", 1)[1].split(".")[0]))
    feats: List[np.ndarray] = []
    for p in parts:
        feats.extend(np.load(p, allow_pickle=True))
    return feats


def _tokens(feat_dir: str, cat: str, unit: str) -> List[np.ndarray]:
    return list(np.load(os.path.join(feat_dir, f"{cat}-{unit}s.npy"),
                        allow_pickle=True))


def main(argv: Optional[Sequence[str]] = None) -> int:
    """Write the shards; returns the number of training records."""
    cfg = parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    os.makedirs(cfg.shard_dir, exist_ok=True)

    maxlen = cfg.maxlen
    if cfg.audio_shards:
        # raw waveforms: the frame-unit cut in samples (frames >= m <=>
        # samples >= m * fstride + flen)
        flen, fstride = frame_params(cfg.sample_rate, cfg.frame_length,
                                     cfg.frame_step)
        maxlen = cfg.maxlen * fstride + flen

    # every train-* and speed_* (augmented, per source cat) feature dump
    cats_on_disk = sorted({
        os.path.basename(p).split("-feats")[0]
        for p in globlib.glob(os.path.join(cfg.feat_dir, "*-feats*"))})
    train_cats = [c for c in cats_on_disk
                  if c.startswith("train-") or c.startswith("speed_")]
    start_index, total = 1, 0
    for cat in train_cats:
        feats = load_cat_feats(cfg.feat_dir, cat)
        tokens = _tokens(cfg.feat_dir, cat, cfg.unit)
        if len(feats) != len(tokens):
            raise ValueError(f"{cat}: {len(feats)} feature records but "
                             f"{len(tokens)} token records")
        paths = shards.create_shards(
            feats, tokens, os.path.join(cfg.shard_dir, "train"),
            records_per_shard=cfg.records_per_shard, maxlen=maxlen,
            shuffle=True, seed=cfg.seed, start_index=start_index)
        n = shards.get_num_records(paths)
        log.info("%s: %d records -> %d shards", cat, n, len(paths))
        start_index += len(paths)
        total += n

    for cat in ("dev", "test"):
        if not globlib.glob(os.path.join(cfg.feat_dir, f"{cat}-feats*")):
            continue
        feats = load_cat_feats(cfg.feat_dir, cat)
        paths = shards.create_shards(
            feats, _tokens(cfg.feat_dir, cat, cfg.unit),
            os.path.join(cfg.shard_dir, cat),
            records_per_shard=max(len(feats), 1), maxlen=None, shuffle=False)
        log.info("%s: %d records -> %s", cat, len(feats), paths)

    log.info("total train records: %d", total)
    return total


if __name__ == "__main__":
    main()
