"""The port's own copy of automatic_speech_recognition_tpu/utils/text.py
(tests/test_torch_shared_copies.py holds it to the original).

Token/string utilities: detokenization and WER.

Reference semantics reproduced from las/utils.py:
- convert_idx_to_string: join tokens, cut at '<EOS>', char mode maps
  '<SPACE>' -> ' ', subword mode maps '</w>' -> ' ', whitespace-normalize
  (las/utils.py:35-46).
- edit_distance: O(nm) DP, returns (distance, len(reference_seq))
  (las/utils.py:54-67); wer = distance / len (las/utils.py:48-52).
"""

from __future__ import annotations

import string
from typing import Dict, Sequence, Tuple

import numpy as np


def convert_idx_to_string(inputs: Sequence[int], id_to_token: Dict[int, str],
                          unit: str = "char") -> str:
    """Convert an id sequence to text (reference: las/utils.py:35-46)."""
    sent = "".join(id_to_token[int(e)] for e in inputs)
    sent = sent.split("<EOS>")[0].strip()
    if unit == "char":
        sent = sent.replace("<SPACE>", " ")
    elif unit == "subword":
        sent = sent.replace("</w>", " ")
    return " ".join(sent.split())


def edit_distance(s1: Sequence, s2: Sequence) -> Tuple[float, int]:
    """Levenshtein distance; returns (distance, len(s1)) (reference: las/utils.py:54-67).

    Vectorized over the inner loop (the reference uses a double Python loop).
    """
    n, m = len(s1), len(s2)
    prev = np.arange(m + 1, dtype=np.float64)
    for i in range(1, n + 1):
        cur = np.empty(m + 1, dtype=np.float64)
        cur[0] = i
        sub = prev[:-1] + (np.asarray([s1[i - 1] != s2[j] for j in range(m)])
                           if m else np.empty(0))
        # dynamic programming: cur[j] = min(prev[j]+1, cur[j-1]+1, sub[j-1])
        for j in range(1, m + 1):
            cur[j] = min(prev[j] + 1, cur[j - 1] + 1, sub[j - 1])
        prev = cur
    return float(prev[-1]), n


def wer(s1: Sequence, s2: Sequence) -> float:
    """Error rate of s2 against reference s1 (reference: las/utils.py:48-52)."""
    e, length = edit_distance(s1, s2)
    return e / length


def _corpus_error_rate(refs: Sequence[str], hyps: Sequence[str],
                       tokenize) -> float:
    """Summed edit distance / summed reference length over a corpus."""
    error, total = 0.0, 0
    for ref, hyp in zip(refs, hyps):
        e, n = edit_distance(tokenize(ref), tokenize(hyp))
        error += e
        total += n
    return error / max(total, 1)


def corpus_wer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus word-level WER: summed edit distance / summed ref length
    (reference: test.py:127-136)."""
    return _corpus_error_rate(refs, hyps, lambda s: s.split(" "))


def corpus_cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus character-level error rate: summed char edit distance /
    summed ref char count.  No reference equivalent (it reports only
    word-level WER, test.py:127-136); CER is the standard companion
    metric for character-output ASR."""
    return _corpus_error_rate(refs, hyps, list)


def strip_punctuation(sentence: str) -> str:
    """Text preprocessing before tokenization (reference: preprocess.py:102)."""
    return sentence.translate(str.maketrans("", "", string.punctuation))


def clean_lm_text(text: str) -> str:
    """LM corpus cleaning (reference: train_lm.py:359-376): blank-line removal,
    newline->space, '?'/'!'->'.', punctuation and digits stripped, uppercase."""
    text = "\n".join(item for item in text.split("\n") if item)
    text = text.replace("\n", " ").replace("  ", " ")
    trans = str.maketrans("?!", "..",
                          '"#$%&\'()*+,-/:;<=>@[\\]^_`{|}~' + "1234567890")
    return text.translate(trans).upper()


def lm_vocab() -> Tuple[Dict[str, int], Dict[int, str], int]:
    """LM char vocab ['.', ' ', A..Z] == 28 ids (reference: train_lm.py:378-386)."""
    unique_chars = [".", " "] + list(string.ascii_uppercase[:26])
    v2i = {c: i for i, c in enumerate(unique_chars)}
    i2v = {i: c for i, c in enumerate(unique_chars)}
    return v2i, i2v, len(unique_chars)
