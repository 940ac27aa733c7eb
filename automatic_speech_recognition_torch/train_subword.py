"""Train the subword (CharBPE) tokenizer on the training transcripts
(counterpart of the repository's train_subword.py, on the same flags;
host only).

    python -m automatic_speech_recognition_torch.train_subword \\
        <train_subword.py's flags> [--size 5000]

Collects every transcript line of the train corpus directories (the
port's preprocess.data_preparation) into <subword_dir>/corpus_all.txt and
trains a CharBPE of --size tokens with utils/tokenizer.SPECIAL_TOKENS,
writing bpe-vocab.json and bpe-merges.txt into --subword_dir.
"""

from __future__ import annotations

import logging
import os
import sys
from typing import Optional, Sequence

from automatic_speech_recognition_torch.config import build_parser
from automatic_speech_recognition_torch.utils.tokenizer import (
    SPECIAL_TOKENS, CharBPE, train_subword_tokenizer)

from .preprocess import data_preparation

log = logging.getLogger("train_subword")


def main(argv: Optional[Sequence[str]] = None) -> CharBPE:
    parser = build_parser()
    parser.add_argument("--size", type=int, default=5000,
                        help="BPE vocab size (reference train_subword.py)")
    args = parser.parse_args(argv)
    logging.basicConfig(force=True, stream=sys.stdout, level=logging.INFO,
                        format="%(asctime)s [%(levelname)s] %(message)s")

    texts = []
    for d in (args.train_100hr_corpus_dir, args.train_360hr_corpus_dir,
              args.train_500hr_corpus_dir):
        if os.path.isdir(d):
            t, _ = data_preparation(d)
            texts.extend(t)
            log.info("%s: %d transcripts", d, len(t))
    if not texts:
        raise FileNotFoundError("no train corpus directories found")

    os.makedirs(args.subword_dir, exist_ok=True)
    corpus = os.path.join(args.subword_dir, "corpus_all.txt")
    with open(corpus, "w") as f:
        f.write("\n".join(texts))
    log.info("corpus written: %s (%d lines)", corpus, len(texts))

    bpe = train_subword_tokenizer(args.size, SPECIAL_TOKENS,
                                  args.subword_dir)
    log.info("BPE trained: vocab %d -> %s", bpe.get_vocab_size(),
             args.subword_dir)
    return bpe


if __name__ == "__main__":
    main()
