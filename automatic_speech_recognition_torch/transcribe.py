"""Transcribe audio files with a trained port checkpoint (counterpart of
the repository's transcribe.py, on the same flags).

    python -m automatic_speech_recognition_torch.transcribe recordings/ \\
        --save_dir exp/model --use_saved_config True --beam_size 8 \\
        --beam_logprob True [--apply_lm True --lm_dir lm/] [--device cuda]

Each path may be a WAV/FLAC file, a directory (searched recursively for
*.wav/*.flac) or a shell-style glob.  Output is one "path<TAB>text" line
per file, to stdout or --output; logs go to stderr.  Decoding runs
through api.Recognizer.from_checkpoint and Recognizer.transcribe
(length-sorted batches of --transcribe_batch files): greedy by default,
beam search with --beam_size > 1 and every beam flag honoured, with each
batch's rows split over every device --device names ('cuda' is every
visible GPU).
`parse` and `expand_paths` are transcribe.py's, written again because
that module imports JAX.
"""

from __future__ import annotations

import glob
import logging
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from automatic_speech_recognition_torch.config import (
    Config, apply_saved_model_config, build_parser)

from .api import Recognizer
from .parallel.mesh import devices_for
from .utils.device import disable_tf32, split_device

log = logging.getLogger("transcribe")

AUDIO_EXTS = (".wav", ".flac")


def parse(argv: Optional[Sequence[str]] = None) -> Tuple[Config, Dict]:
    p = build_parser()
    g = p.add_argument_group("transcribe")
    g.add_argument("paths", nargs="+",
                   help="audio files, directories, or globs")
    g.add_argument("--output", type=str, default="",
                   help="write path<TAB>text lines here instead of stdout")
    g.add_argument("--transcribe_batch", type=int, default=8,
                   help="files per device dispatch")
    ns = vars(p.parse_args(argv))
    opts = {k: ns.pop(k) for k in ("paths", "output", "transcribe_batch")}
    return Config(**ns), opts


def expand_paths(patterns: Sequence[str]) -> List[str]:
    """Files / recursive directories / globs -> ordered unique file list."""
    out = []
    for pat in patterns:
        if os.path.isdir(pat):
            hits = sorted(
                os.path.join(r, f)
                for r, _, fs in os.walk(pat) for f in fs
                if f.lower().endswith(AUDIO_EXTS))
        elif os.path.exists(pat):
            if not pat.lower().endswith(AUDIO_EXTS):
                raise ValueError(
                    f"{pat!r} exists but is not a supported audio file "
                    f"(want one of {', '.join(AUDIO_EXTS)})")
            hits = [pat]
        else:
            hits = sorted(h for h in glob.glob(pat, recursive=True)
                          if h.lower().endswith(AUDIO_EXTS))
        if not hits:
            raise FileNotFoundError(f"no audio files match {pat!r}")
        out.extend(hits)
    seen = set()
    return [p for p in out if not (p in seen or seen.add(p))]


def main(argv: Optional[Sequence[str]] = None) -> List[str]:
    """Transcribe; returns the texts in the order of the expanded paths."""
    device_name, argv = split_device(argv)
    cfg, opts = parse(argv)
    logging.basicConfig(force=True, stream=sys.stderr, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")
    if cfg.use_saved_config:
        cfg, overridden = apply_saved_model_config(cfg, cfg.save_dir)
        for line in overridden:
            log.info("model flag from training snapshot: %s", line)
    if devices_for(device_name)[0].type == "cuda":
        disable_tf32()
    paths = expand_paths(opts["paths"])
    beam_size = cfg.beam_size if cfg.beam_size > 1 else 0
    log.info("transcribing %d files (beam %s, lm %s) on %s", len(paths),
             beam_size or "greedy", bool(cfg.apply_lm), device_name)
    rec = Recognizer.from_checkpoint(
        cfg.save_dir, cfg, epoch=cfg.restore_epoch,
        lm_dir=cfg.lm_dir if cfg.apply_lm else "", device=device_name)
    texts = rec.transcribe(paths, beam_size=beam_size,
                           batch_size=opts["transcribe_batch"])
    lines = [f"{p}\t{t}" for p, t in zip(paths, texts)]
    if opts["output"]:
        os.makedirs(os.path.dirname(opts["output"]) or ".", exist_ok=True)
        with open(opts["output"], "w") as f:
            f.write("\n".join(lines) + "\n")
        log.info("wrote %d transcripts to %s", len(lines), opts["output"])
    else:
        for line in lines:
            print(line)
    return texts


if __name__ == "__main__":
    main()
