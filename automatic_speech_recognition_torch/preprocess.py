"""Corpus preprocessing: transcripts -> token ids, audio -> features
(counterpart of the repository's preprocess.py, on the same flags).

    python -m automatic_speech_recognition_torch.preprocess <preprocess.py's \\
        flags> [--device cuda]

Walks each LibriSpeech-layout corpus directory of the config (train-100,
train-360, train-500, dev, test), pairs transcript lines with their
.flac / .wav files, decodes the audio on the host (a thread pool) and
featurizes it on the device in length-sorted batches through
ops/frontend.extract_features_list, the fused CUDA kernel on a GPU.  With
--augmentation True every train set is also written sped up by 0.9 and
1.1 (ops/augmentation.speed_perturb, under speed_{s}_{cat}); with
--audio_shards True the raw waveforms are dumped instead of features.

Output in --feat_dir, file for file what preprocess.py writes, so either
package's create_shards reads either's dumps:
  {cat}-feats.npy / {cat}-feats-{i}.npy   object arrays of (T, D, 3) float32
                                          (raw: (S, 1, 1)), split past
                                          --sample_threshold utterances
  {cat}-featlen.npy                       int32 lengths
  {cat}-{unit}s.npy, {cat}-{unit}len.npy  ragged token ids + lengths

Tiny CPU run:
  python -m automatic_speech_recognition_torch.preprocess --device cpu \\
      --unit char --dev_data_dir <corpus> --feat_dir /tmp/feats
"""

from __future__ import annotations

import glob as globlib
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from automatic_speech_recognition_torch.config import Config, parse_args
from automatic_speech_recognition_torch.data.audio_io import read_audio
from automatic_speech_recognition_torch.utils.numerics import cdiv
from automatic_speech_recognition_torch.utils.text import strip_punctuation
from automatic_speech_recognition_torch.utils.tokenizer import get_tokenizer

from .ops import augmentation, frontend
from .utils.device import disable_tf32, resolve_device, split_device

log = logging.getLogger("preprocess")


def data_preparation(libri_path: str) -> Tuple[List[str], List[str]]:
    """Pair transcript lines with audio files (reference: preprocess.py:
    26-48): walks <libri_path>/**/**/, reads each chapter's .txt, pairs
    every line with `<utt_id>.flac` (or `.wav`), strips apostrophes."""
    folders = sorted(globlib.glob(os.path.join(libri_path, "**", "**")))
    texts, audio_path = [], []
    for path in folders:
        txts = sorted(globlib.glob(os.path.join(path, "*txt")))
        if not txts:
            continue
        with open(txts[0]) as f:
            for line in f.readlines():
                head = line.split(" ")[0]
                base = os.path.join(path, head)
                for ext in (".flac", ".wav"):
                    if os.path.exists(base + ext):
                        cand = base + ext
                        break
                else:
                    raise FileNotFoundError(
                        f"transcript {txts[0]} references {head} but "
                        f"neither {base}.flac nor {base}.wav exists")
                audio_path.append(cand)
                # rstrip, not [:-1]: a final line without '\n' keeps its
                # last character
                texts.append(
                    line.rstrip("\n")[len(head) + 1:].replace("'", ""))
    return texts, audio_path


def _object_array(items: Sequence) -> np.ndarray:
    arr = np.empty(len(items), dtype=object)
    for i, x in enumerate(items):
        arr[i] = x
    return arr


def process_texts(texts: Sequence[str], tokenizer
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Strip punctuation, tokenize, append EOS (reference: preprocess.py:
    93-107)."""
    tokens, tokenlen = [], []
    for t in texts:
        ids = tokenizer.encode(strip_punctuation(t), with_eos=True)
        tokens.append(np.asarray(ids, np.int32))
        tokenlen.append(len(ids))
    return _object_array(tokens), np.asarray(tokenlen, np.int32)


def load_signals(audio_path: Sequence[str], sample_rate: int,
                 num_workers: int = 8) -> List[np.ndarray]:
    """Decode audio files on the host with a thread pool (the native FLAC
    decoder releases the GIL during its ctypes calls)."""
    def one(p):
        sig, sr = read_audio(p)
        if sr != sample_rate:
            raise ValueError(f"{p}: sample rate {sr} != {sample_rate}")
        return np.asarray(sig, np.float32)

    with ThreadPoolExecutor(max_workers=num_workers) as ex:
        return list(ex.map(one, audio_path))


def process_audios(signals: Sequence[np.ndarray], cfg: Config,
                   device: torch.device) -> Tuple[np.ndarray, np.ndarray]:
    """Batched featurization on the device; (object array, lengths)."""
    feats = frontend.extract_features_list(signals, cfg, device)
    featlen = np.asarray([len(f) for f in feats], np.int32)
    return _object_array(feats), featlen


def save_feats(cfg: Config, cat: str, audio_path: Sequence[str],
               device: torch.device,
               transform: Optional[Callable[[np.ndarray], np.ndarray]] = None
               ) -> None:
    """Featurize (or dump raw) one category, in parts of at most
    cfg.sample_threshold utterances past that many (the reference's
    >30k split, preprocess.py:17, :112-125), so host memory holds one
    part's audio at a time.  transform: a per-signal function (speed
    augmentation)."""
    thr = cfg.sample_threshold

    def featurize(paths):
        signals = load_signals(paths, cfg.sample_rate)
        if transform is not None:
            signals = [transform(s) for s in signals]
        if cfg.audio_shards:
            # raw-waveform mode: (S, 1, 1) float32 signals under the same
            # names; the frontend runs inside the train / eval step
            sigs = [np.asarray(s, np.float32).reshape(-1, 1, 1)
                    for s in signals]
            return (_object_array(sigs),
                    np.asarray([len(s) for s in sigs], np.int32))
        t0 = time.perf_counter()
        out = process_audios(signals, cfg, device)
        dt = time.perf_counter() - t0
        log.info("%s: featurized %d utterances in %.3f s (%.1f utt/s) on %s",
                 cat, len(signals), dt, len(signals) / max(dt, 1e-9),
                 device)
        return out

    if len(audio_path) > thr:
        # ceil so no part exceeds the threshold
        k = cdiv(len(audio_path), thr)
        n = cdiv(len(audio_path), k)
        featlen_all = []
        for i in range(k):
            chunk = audio_path[i * n:(i + 1) * n]
            if not chunk:  # k*n can overshoot len by a few slots
                break
            feats, featlen = featurize(chunk)
            featlen_all.extend(featlen.tolist())
            np.save(os.path.join(cfg.feat_dir, f"{cat}-feats-{i}.npy"),
                    feats, allow_pickle=True)
        featlen = np.asarray(featlen_all, np.int32)
    else:
        feats, featlen = featurize(audio_path)
        np.save(os.path.join(cfg.feat_dir, f"{cat}-feats.npy"),
                feats, allow_pickle=True)
    np.save(os.path.join(cfg.feat_dir, f"{cat}-featlen.npy"), featlen)


def main_libri(cfg: Config, tokenizer, device: torch.device) -> None:
    path = [("train-100", cfg.train_100hr_corpus_dir),
            ("train-360", cfg.train_360hr_corpus_dir),
            ("train-500", cfg.train_500hr_corpus_dir),
            ("dev", cfg.dev_data_dir),
            ("test", cfg.test_data_dir)]
    os.makedirs(cfg.feat_dir, exist_ok=True)
    for cat, libri_path in path:
        if not os.path.isdir(libri_path):
            log.info("skip %s (no directory %s)", cat, libri_path)
            continue
        texts, audio_path = data_preparation(libri_path)
        log.info("%s: %d utterances", cat, len(texts))
        tokens, tokenlen = process_texts(texts, tokenizer)
        np.save(os.path.join(cfg.feat_dir, f"{cat}-{cfg.unit}s.npy"),
                tokens, allow_pickle=True)
        np.save(os.path.join(cfg.feat_dir, f"{cat}-{cfg.unit}len.npy"),
                tokenlen)
        save_feats(cfg, cat, audio_path, device)
        if cfg.augmentation and "train" in cat:
            for s in augmentation.SPEED_LIST:
                # per-source-cat names so several train sets do not
                # overwrite each other's augmented dumps
                aug_cat = f"speed_{s}_{cat}"
                log.info("speed augmentation x%.1f for %s", s, cat)
                save_feats(cfg, aug_cat, audio_path, device,
                           transform=lambda sig, sp=s:
                           augmentation.speed_perturb(sig, sp))
                np.save(os.path.join(cfg.feat_dir,
                                     f"{aug_cat}-{cfg.unit}s.npy"),
                        tokens, allow_pickle=True)
                np.save(os.path.join(cfg.feat_dir,
                                     f"{aug_cat}-{cfg.unit}len.npy"),
                        tokenlen)


def main(argv: Optional[Sequence[str]] = None) -> None:
    device_name, argv = split_device(argv)
    cfg = parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    log.info("parameters:\n%s", cfg.to_json())
    if cfg.dataset != "LibriSpeech":
        raise ValueError(f"unknown dataset {cfg.dataset!r} (LibriSpeech "
                         "layout only)")
    device = resolve_device(device_name)
    if device.type == "cuda":
        disable_tf32()
    main_libri(cfg, get_tokenizer(cfg.unit, cfg.subword_dir), device)


if __name__ == "__main__":
    main()
