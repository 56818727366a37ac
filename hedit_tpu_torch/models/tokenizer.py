"""CLIP BPE tokenizer (own copy of ``hedit_tpu/models/tokenizer.py``).

Behaviour of the OpenAI / HF CLIPTokenizer that the reference uses
(``inversion_utils.py:13-35``: pad to max_length=77, truncate): lower-cased
byte-pair encoding over the standard 16e6 merge table, <|startoftext|> /
<|endoftext|> specials, endoftext padding.  Needs the ``regex`` package.

The merge table ``bpe_simple_vocab_16e6.txt.gz`` is data, not a module: the
repository holds one copy, beside the JAX package's tokenizer
(``hedit_tpu/models/``), and this module reads it by path where it lies
rather than keep a second copy of the binary.  The ``HEDIT_BPE_VOCAB``
environment variable names another file.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
from typing import Dict, List, Tuple

import numpy as np
import regex as re

SOT = "<|startoftext|>"
EOT = "<|endoftext|>"
MAX_LEN = 77

_REPO_VOCAB = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "hedit_tpu", "models", "bpe_simple_vocab_16e6.txt.gz")


def find_vocab_file() -> str:
    path = os.environ.get("HEDIT_BPE_VOCAB") or _REPO_VOCAB
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"CLIP BPE merge table not found at {path}; set HEDIT_BPE_VOCAB to a "
            "bpe_simple_vocab_16e6.txt.gz file")
    return path


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """Reversible byte -> printable-unicode-char map (standard GPT-2/CLIP)."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def _clean(text: str) -> str:
    # ftfy.fix_text is a no-op for well-formed input; html unescape + collapse
    text = html.unescape(html.unescape(text))
    return re.sub(r"\s+", " ", text).strip()


class CLIPTokenizer:
    def __init__(self, vocab_path: str | None = None):
        vocab_path = vocab_path or find_vocab_file()
        with gzip.open(vocab_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges[1 : 49152 - 256 - 2 + 1]]
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab += ["".join(m) for m in merges]
        vocab += [SOT, EOT]
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self._cache = {SOT: SOT, EOT: EOT}
        self.pat = re.compile(
            r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
            r"[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+",
            re.IGNORECASE,
        )
        self.sot_id = self.encoder[SOT]
        self.eot_id = self.encoder[EOT]

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        """Raw BPE ids, no specials (parity with HF tokenizer.encode minus
        specials; used by the P2P word-index helpers)."""
        ids: List[int] = []
        text = _clean(text).lower()
        for tok in re.findall(self.pat, text):
            tok = "".join(self.byte_encoder[b] for b in tok.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(tok).split(" "))
        return ids

    def decode(self, ids) -> str:
        if np.isscalar(ids) or isinstance(ids, (int, np.integer)):
            ids = [int(ids)]
        text = "".join(self.decoder[int(i)] for i in ids)
        raw = bytearray(self.byte_decoder[c] for c in text if c in self.byte_decoder)
        return raw.decode("utf-8", errors="replace").replace("</w>", " ")

    def __call__(self, texts, max_length: int = MAX_LEN) -> np.ndarray:
        """Batch-encode with SOT/EOT, truncation, and EOT padding -> [B, 77]
        int32 — the `padding='max_length', truncation=True` contract of
        ``encode_text`` (``inversion_utils.py:24-31``)."""
        if isinstance(texts, str):
            texts = [texts]
        out = np.full((len(texts), max_length), self.eot_id, dtype=np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot_id] + self.encode(text)[: max_length - 2] + [self.eot_id]
            out[i, : len(ids)] = ids
        return out
