"""CLIP byte-level BPE tokenizer (self-contained).

Copied from `diffcodec_tpu/utils/tokenizer.py` so the port imports nothing
of the JAX package.  Parity target: the HF `CLIPTokenizer` the reference
loads (`train_controlnet.py:793-796`): byte-level BPE over the
`bpe_simple_vocab_16e6` merges, lowercased, whitespace-normalised,
`<|startoftext|> ... <|endoftext|>` framing, padded to 77 with the EOT id.

The merges file ships with CLIP/SD checkpoints (not with this repo);
`ClipTokenizer.from_merges_file` loads it when available (its path also
from `$DIFFCODEC_CLIP_BPE`).  For tests and caption-free operation
(captions are dropped 30% of the time in training and the codec typically
runs with a fixed prompt), `HashTokenizer` provides a deterministic
stand-in with the same interface; `default_tokenizer` picks the first when
the merges are there, else the second.
"""

from __future__ import annotations

import gzip
import html
import os
import re
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


@lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte->unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("¡"), ord("¬") + 1)) +
          list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    pairs = set()
    prev = word[0]
    for ch in word[1:]:
        pairs.add((prev, ch))
        prev = ch
    return pairs


def whitespace_clean(text: str) -> str:
    text = re.sub(r"\s+", " ", text)
    return text.strip()


# ASCII approximation of CLIP's \p{L}/\p{N} classes (stdlib `re` has no
# unicode property escapes; captions in the training data are English)
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d|"
    r"[A-Za-z]+|[0-9]|[^\sA-Za-z0-9]+",
    re.IGNORECASE)


class ClipTokenizer:
    """Byte-level BPE tokenizer with the CLIP vocabulary layout."""

    def __init__(self, merges: Sequence[Tuple[str, str]],
                 context_length: int = 77):
        self.byte_encoder = bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.bpe_ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.sot = self.encoder["<|startoftext|>"]
        self.eot = self.encoder["<|endoftext|>"]
        self.context_length = context_length
        self._cache: Dict[str, str] = {}

    @classmethod
    def from_merges_file(cls, path: Optional[str] = None,
                         context_length: int = 77):
        """Load `bpe_simple_vocab_16e6.txt[.gz]`; path also via
        $DIFFCODEC_CLIP_BPE.  Returns None when unavailable."""
        path = path or os.environ.get("DIFFCODEC_CLIP_BPE", "")
        if not path or not os.path.exists(path):
            return None
        if path.endswith(".gz"):
            with gzip.open(path, "rt", encoding="utf-8") as f:
                lines = f.read().split("\n")
        else:
            with open(path, encoding="utf-8") as f:
                lines = f.read().split("\n")
        merges = [tuple(line.split()) for line in
                  lines[1:49152 - 256 - 2 + 1] if line]
        return cls(merges, context_length)

    def bpe(self, token: str) -> str:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(
                p, float("inf")))
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
                if (i < len(word) - 1 and word[i] == first and
                        word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self._cache[token] = out
        return out

    def encode_text(self, text: str) -> List[int]:
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b]
                            for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Batch tokenize -> [B, context_length] int32 (sot ... eot pad=eot,
        truncated like CLIP)."""
        L = self.context_length
        out = np.full((len(texts), L), self.eot, np.int32)
        for i, text in enumerate(texts):
            ids = [self.sot] + self.encode_text(text)[:L - 2] + [self.eot]
            out[i, :len(ids)] = ids
        return out


class HashTokenizer:
    """Deterministic stand-in with the CLIP interface (tests / no-vocab)."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77):
        self.vocab_size = vocab_size
        self.context_length = context_length
        self.sot = vocab_size - 2
        self.eot = vocab_size - 1

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        L = self.context_length
        out = np.full((len(texts), L), self.eot, np.int32)
        import zlib
        for i, text in enumerate(texts):
            words = whitespace_clean(text).lower().split()[:L - 2]
            ids = [self.sot] + [
                (zlib.crc32(w.encode()) % (self.vocab_size - 2))
                for w in words] + [self.eot]
            out[i, :len(ids)] = ids
        return out


def default_tokenizer(context_length: int = 77):
    tok = ClipTokenizer.from_merges_file(context_length=context_length)
    return tok if tok is not None else HashTokenizer(
        context_length=context_length)
