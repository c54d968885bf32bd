"""CLIP byte-pair-encoding tokenizer (a copy of segsplat_tpu/models/tokenizer.py,
which imports no JAX; the port keeps its own).

The reference tokenizes prompts with ``clip.tokenize`` (voxeltoGaussian_logits.py:170).
CLIP's BPE needs its merges table (``bpe_simple_vocab_16e6.txt.gz``); in an
offline environment that file may be absent, so this module provides:

  * ``ClipTokenizer`` — the real byte-level BPE when a merges file is available
    (pass ``bpe_path`` or set SEGSPLAT_CLIP_BPE),
  * ``HashTokenizer`` — a deterministic fallback that maps whitespace-split words
    into the same vocab range. NOT compatible with pretrained weights; it exists so
    the text tower is exercisable end-to-end (tests, randomly-initialized models)
    without network access. Pipelines that load real CLIP weights must supply the
    merges file.
"""

from __future__ import annotations

import functools
import gzip
import html
import os
import re
from typing import List, Optional

import numpy as np

CONTEXT_LENGTH = 77
VOCAB_SIZE = 49408
SOT = VOCAB_SIZE - 2   # <|startoftext|>
EOT = VOCAB_SIZE - 1   # <|endoftext|>


@functools.lru_cache()
def _bytes_to_unicode():
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _basic_clean(text: str) -> str:
    return html.unescape(html.unescape(text)).strip().lower()


@functools.lru_cache()
def _non_decimal_numerics() -> str:
    """Character-class body for Unicode categories Nl and No.

    CLIP's pre-split regex uses the `regex` module's \\p{N}, which covers
    Nd ∪ Nl ∪ No; stdlib ``\\d`` is Nd only, and Python's ``[^\\W\\d_]``
    letter class would absorb the alnum Nl/No characters ('½', 'Ⅻ', '²')
    into letter runs — different token ids than clip.tokenize. Enumerated
    once from unicodedata (~1.1k chars → compressed ranges)."""
    import unicodedata

    ranges: List[tuple] = []
    start = prev = None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)) in ("Nl", "No"):
            if prev is not None and cp == prev + 1:
                prev = cp
                continue
            if start is not None:
                ranges.append((start, prev))
            start = prev = cp
    if start is not None:
        ranges.append((start, prev))
    return "".join(
        re.escape(chr(a)) if a == b
        else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
        for a, b in ranges)


# CLIP SimpleTokenizer's pre-split regex, transcribed from the `regex`
# module's \p classes to stdlib re: contraction suffixes are their own
# tokens, letter RUNS stay whole, numerics (\p{N} = \d plus the Nl/No table
# above) split ONE PER TOKEN, and punctuation (incl. underscore) groups into
# runs. A simplified isalnum walker used here previously glued contractions
# ("it's") and kept digit runs whole ("25cm") — different token ids than
# clip.tokenize, which silently breaks parity with real converted CLIP
# weights.
@functools.lru_cache()
def _pat() -> "re.Pattern":
    ex = _non_decimal_numerics()
    return re.compile(
        r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
        rf"|[^\W\d_{ex}]+|[\d{ex}]|(?:[^\s\w]|_)+",
        re.IGNORECASE)


def _word_split(text: str) -> List[str]:
    return _pat().findall(text)


class ClipTokenizer:
    """Byte-level BPE identical in contract to openai/CLIP's SimpleTokenizer."""

    def __init__(self, bpe_path: Optional[str] = None):
        bpe_path = bpe_path or os.environ.get("SEGSPLAT_CLIP_BPE", "")
        if not bpe_path or not os.path.exists(bpe_path):
            raise FileNotFoundError(
                "CLIP BPE merges file not found; pass bpe_path or set "
                "SEGSPLAT_CLIP_BPE (bpe_simple_vocab_16e6.txt[.gz])")
        opener = gzip.open if bpe_path.endswith(".gz") else open
        with opener(bpe_path, "rt", encoding="utf-8") as f:
            merges = f.read().split("\n")[1:49152 - 256 - 2 + 1]
        merges = [tuple(m.split()) for m in merges if m]
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        for m in merges:
            vocab.append("".join(m))
        vocab.extend(["<|startoftext|>", "<|endoftext|>"])
        self.encoder = {v: i for i, v in enumerate(vocab)}
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}

    def _bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word[:-1], word[1:]))
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _word_split(_basic_clean(text)):
            token = "".join(self.byte_encoder[b] for b in word.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self._bpe(token).split(" "))
        return ids

    def __call__(self, texts) -> np.ndarray:
        return tokenize_with(self.encode, texts)


class HashTokenizer:
    """Deterministic offline fallback (NOT weight-compatible with CLIP)."""

    def encode(self, text: str) -> List[int]:
        ids = []
        for word in _word_split(_basic_clean(text)):
            h = 2166136261
            for ch in word.encode("utf-8"):
                h = ((h ^ ch) * 16777619) & 0xFFFFFFFF
            ids.append(h % (VOCAB_SIZE - 2))
        return ids

    def __call__(self, texts) -> np.ndarray:
        return tokenize_with(self.encode, texts)


def tokenize_with(encode_fn, texts) -> np.ndarray:
    """[P, 77] int32 with SOT/EOT framing and truncation, like clip.tokenize."""
    if isinstance(texts, str):
        texts = [texts]
    out = np.zeros((len(texts), CONTEXT_LENGTH), np.int32)
    for i, t in enumerate(texts):
        ids = [SOT] + encode_fn(t)[:CONTEXT_LENGTH - 2] + [EOT]
        out[i, :len(ids)] = ids
    return out


def get_tokenizer(bpe_path: Optional[str] = None):
    """Real BPE when merges are available, hash fallback otherwise."""
    try:
        return ClipTokenizer(bpe_path)
    except FileNotFoundError:
        return HashTokenizer()
