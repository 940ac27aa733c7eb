"""The port's own copy of automatic_speech_recognition_tpu/utils/tokenizer.py
(tests/test_torch_shared_copies.py holds it to the original).

Text tokenization: char vocabulary and CharBPE subwords.

Reference behavior being reproduced:
- CharEncoder vocab ['<PAD>','<SOS>','<EOS>','<SPACE>'] + A..Z -> ids 0..29,
  space -> '<SPACE>', optional trailing '<EOS>' (reference: utils/tokenizer.py:87-117,
  :4-23).
- SubwordEncoder loads `bpe-vocab.json` / `bpe-merges.txt` produced by the
  HuggingFace CharBPETokenizer and appends '<EOS>' == id 2 manually
  (reference: utils/tokenizer.py:43-85).
- train_subword_tokenizer trains BPE with specials
  ['<PAD>','<SOS>','<EOS>','<unk>'], min_frequency 2, end-of-word suffix
  '</w>' (reference: utils/tokenizer.py:26-41).

Unlike the reference, the BPE here is a small dependency-free pure-Python
implementation (train + encode + decode) that reads/writes the exact same
file formats, so checkpoints and vocab files are interchangeable.  Its
encoding is validated against the real Rust tokenizer in
tests/test_tokenizer.py when `tokenizers` is importable.
"""

from __future__ import annotations

import json
import os
import string
import unicodedata
from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

SPECIAL_TOKENS = ["<PAD>", "<SOS>", "<EOS>", "<SPACE>"]
PAD_ID, SOS_ID, EOS_ID, SPACE_ID = 0, 1, 2, 3
SUFFIX = "</w>"


def lookup_dicts(special_tokens: Sequence[str]):
    """Char vocab maps (reference: utils/tokenizer.py:6-23)."""
    alphas = list(string.ascii_uppercase[:26])
    tokens = list(special_tokens) + alphas
    token_to_id = {c: i for i, c in enumerate(tokens)}
    id_to_token = {i: c for i, c in enumerate(tokens)}
    return token_to_id, id_to_token


class CharEncoder:
    """Character tokenization (reference: utils/tokenizer.py:87-117)."""

    def __init__(self):
        self.char2id, self.id2char = lookup_dicts(SPECIAL_TOKENS)
        self.token_to_id = self.char2id
        self.id_to_token = self.id2char

    def get_vocab_size(self) -> int:
        return len(self.id2char)

    def encode(self, sentence: str, with_eos: bool = False) -> List[int]:
        tokens = [self.char2id[c] if c != " " else self.char2id["<SPACE>"]
                  for c in sentence]
        if with_eos:
            tokens.append(self.char2id["<EOS>"])
        return tokens

    def decode(self, ids: Iterable[int]) -> str:
        out = []
        for i in ids:
            tok = self.id2char[int(i)]
            if tok == "<EOS>":
                break
            out.append(" " if tok == "<SPACE>" else tok)
        return "".join(out).strip()


# ---------------------------------------------------------------------------
# Pure-Python CharBPE
# ---------------------------------------------------------------------------

def _bert_clean(text: str) -> str:
    """BertNormalizer.clean_text subset: drop control chars, unify whitespace.

    The HF CharBPETokenizer applies BertNormalizer(lowercase=False) before
    pre-tokenization; for the LibriSpeech ASCII domain only the control/ws
    cleanup is observable.
    """
    out = []
    for ch in text:
        if ch in ("\t", "\n", "\r"):
            out.append(" ")
            continue
        cat = unicodedata.category(ch)
        if cat.startswith("C"):
            continue
        out.append(ch)
    return "".join(out)


def _pre_tokenize(text: str) -> List[str]:
    """BertPreTokenizer subset: whitespace split + punctuation isolation."""
    words: List[str] = []
    cur: List[str] = []
    for ch in _bert_clean(text):
        if ch.isspace():
            if cur:
                words.append("".join(cur))
                cur = []
        elif unicodedata.category(ch).startswith("P"):
            if cur:
                words.append("".join(cur))
                cur = []
            words.append(ch)
        else:
            cur.append(ch)
    if cur:
        words.append("".join(cur))
    return words


def _word_symbols(word: str) -> Tuple[str, ...]:
    """Split a word into BPE start symbols; last char carries the suffix."""
    if not word:
        return ()
    chars = list(word)
    chars[-1] = chars[-1] + SUFFIX
    return tuple(chars)


class CharBPE:
    """Byte-pair-encoding over characters with an end-of-word suffix.

    File-format compatible with HuggingFace CharBPETokenizer
    (`bpe-vocab.json` + `bpe-merges.txt`).
    """

    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 unk_token: str = "<unk>"):
        self.vocab = dict(vocab)
        self.inv_vocab = {i: t for t, i in self.vocab.items()}
        self.merges = list(merges)
        self.merge_rank = {pair: r for r, pair in enumerate(self.merges)}
        self.unk_token = unk_token
        self.unk_id = self.vocab.get(unk_token, 0)
        self._cache: Dict[str, List[int]] = {}

    # -- persistence -------------------------------------------------------
    @classmethod
    def load(cls, vocab_file: str, merges_file: str, unk_token: str = "<unk>") -> "CharBPE":
        with open(vocab_file, "r", encoding="utf-8") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        with open(merges_file, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line or line.startswith("#version"):
                    continue
                a, b = line.split(" ")
                merges.append((a, b))
        return cls(vocab, merges, unk_token)

    def save(self, directory: str, name: str = "bpe") -> Tuple[str, str]:
        os.makedirs(directory, exist_ok=True)
        vocab_file = os.path.join(directory, f"{name}-vocab.json")
        merges_file = os.path.join(directory, f"{name}-merges.txt")
        with open(vocab_file, "w", encoding="utf-8") as f:
            json.dump(self.vocab, f, ensure_ascii=False)
        with open(merges_file, "w", encoding="utf-8") as f:
            f.write("#version: 0.2\n")
            for a, b in self.merges:
                f.write(f"{a} {b}\n")
        return vocab_file, merges_file

    # -- encoding ----------------------------------------------------------
    def _encode_word(self, word: str) -> List[int]:
        if word in self._cache:
            return self._cache[word]
        symbols = list(_word_symbols(word))
        if not symbols:
            return []
        while len(symbols) > 1:
            best_rank, best_i = None, -1
            for i in range(len(symbols) - 1):
                r = self.merge_rank.get((symbols[i], symbols[i + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_rank is None:
                break
            symbols[best_i:best_i + 2] = [symbols[best_i] + symbols[best_i + 1]]
        ids = [self.vocab.get(s, self.unk_id) for s in symbols]
        self._cache[word] = ids
        return ids

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        for word in _pre_tokenize(text):
            ids.extend(self._encode_word(word))
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        toks = [self.inv_vocab.get(int(i), self.unk_token) for i in ids]
        return "".join(toks).replace(SUFFIX, " ").strip()

    def get_vocab_size(self) -> int:
        return len(self.vocab)

    # -- training ----------------------------------------------------------
    @classmethod
    def train(cls, texts: Iterable[str], vocab_size: int, min_frequency: int = 2,
              special_tokens: Sequence[str] = ("<PAD>", "<SOS>", "<EOS>", "<unk>"),
              unk_token: str = "<unk>") -> "CharBPE":
        """Train BPE merges (semantics of HF BpeTrainer with end_of_word_suffix).

        Vocab order: specials, sorted bare alphabet, suffixed end-chars in
        encounter order, then merge products in creation order.
        """
        word_counts: Counter = Counter()
        for line in texts:
            for w in _pre_tokenize(line):
                word_counts[w] += 1

        vocab: Dict[str, int] = {}
        for tok in special_tokens:
            vocab[tok] = len(vocab)

        # alphabet: bare characters, sorted (HF compute_alphabet)
        alphabet = sorted({ch for w in word_counts for ch in w})
        for ch in alphabet:
            if ch not in vocab:
                vocab[ch] = len(vocab)
        # suffixed forms of word-final characters, in encounter order
        words: Dict[str, List[str]] = {}
        for w in word_counts:
            syms = list(_word_symbols(w))
            words[w] = syms
            last = syms[-1]
            if last not in vocab:
                vocab[last] = len(vocab)

        merges: List[Tuple[str, str]] = []

        def count_pairs() -> Counter:
            pc: Counter = Counter()
            for w, syms in words.items():
                c = word_counts[w]
                for i in range(len(syms) - 1):
                    pc[(syms[i], syms[i + 1])] += c
            return pc

        pair_counts = count_pairs()
        while len(vocab) < vocab_size and pair_counts:
            # highest count; ties by lowest (id_a, id_b)
            best = min(pair_counts.items(),
                       key=lambda kv: (-kv[1], vocab.get(kv[0][0], 1 << 30),
                                       vocab.get(kv[0][1], 1 << 30)))
            (a, b), cnt = best
            if cnt < min_frequency:
                break
            new_tok = a + b
            if new_tok not in vocab:
                vocab[new_tok] = len(vocab)
            merges.append((a, b))
            # apply merge in place, updating pair counts incrementally
            for w, syms in words.items():
                c = word_counts[w]
                i = 0
                while i < len(syms) - 1:
                    if syms[i] == a and syms[i + 1] == b:
                        if i > 0:
                            pair_counts[(syms[i - 1], a)] -= c
                            pair_counts[(syms[i - 1], new_tok)] += c
                        if i + 2 < len(syms):
                            pair_counts[(b, syms[i + 2])] -= c
                            pair_counts[(new_tok, syms[i + 2])] += c
                        syms[i:i + 2] = [new_tok]
                    else:
                        i += 1
            del pair_counts[(a, b)]
            pair_counts = Counter({k: v for k, v in pair_counts.items() if v > 0})
        return cls(vocab, merges, unk_token)


def train_subword_tokenizer(size: int, special_tokens: Sequence[str], path: str) -> CharBPE:
    """Train subword tokenizer from `<path>/corpus_all.txt` and save `bpe-*`
    files (reference: utils/tokenizer.py:26-41)."""
    corpus = os.path.join(path, "corpus_all.txt")
    with open(corpus, "r", encoding="utf-8") as f:
        lines = f.readlines()
    bpe = CharBPE.train(lines, vocab_size=size, min_frequency=2,
                        special_tokens=list(special_tokens[:3]) + ["<unk>"])
    bpe.save(path, "bpe")
    return bpe


class SubwordEncoder:
    """Subword tokenization over saved bpe files (reference: utils/tokenizer.py:43-85)."""

    def __init__(self, path: str = "subword/"):
        self.bpe = CharBPE.load(os.path.join(path, "bpe-vocab.json"),
                                os.path.join(path, "bpe-merges.txt"))
        self.id_to_token = {i: self.bpe.inv_vocab.get(i, "<unk>")
                            for i in range(self.get_vocab_size())}
        self.token_to_id = {t: i for i, t in self.id_to_token.items()}

    def get_vocab_size(self) -> int:
        return self.bpe.get_vocab_size()

    def encode(self, sentence: str, with_eos: bool = False) -> List[int]:
        tokens = self.bpe.encode(sentence)
        if with_eos:
            tokens = tokens + [EOS_ID]  # reference: utils/tokenizer.py:71-72
        return tokens

    def decode(self, ids: Iterable[int]) -> str:
        kept = []
        for i in ids:
            if int(i) == EOS_ID:
                break
            kept.append(int(i))
        return self.bpe.decode(kept)


def get_tokenizer(unit: str, subword_dir: str = "subword/"):
    """Pick tokenizer by unit (reference: preprocess.py:192-198)."""
    if unit == "char":
        return CharEncoder()
    if unit == "subword":
        return SubwordEncoder(subword_dir)
    raise ValueError(f"unknown unit: {unit}")
