"""CLIP byte-level BPE tokenizer, numpy only.

A copy of :mod:`t2igan.data.tokenizer` for the PyTorch port, which imports
nothing of the JAX package.  It implements HuggingFace ``CLIPTokenizer``'s
algorithm (lowercase + whitespace cleanup, byte-to-unicode mapping, greedy
pair merges with an end-of-word marker, ``<|startoftext|>`` /
``<|endoftext|>`` specials) and

* loads the standard ``vocab.json`` + ``merges.txt`` files from a directory
  when they are there, and
* otherwise falls back to a deterministic byte-level vocabulary (no merges)
  with the same id space (49408), the same specials and the same
  padding/truncation semantics as
  ``tokenizer.batch_encode_plus(padding='max_length', truncation=True)``.
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

BOS_TOKEN = "<|startoftext|>"
EOS_TOKEN = "<|endoftext|>"
VOCAB_SIZE = 49408


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2 style reversible byte <-> printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(ord("\xa1"), ord("\xac") + 1)) +
          list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


# CLIP's token pattern; python `re` spellings of \p{L} / \p{N}.
_PAT = re.compile(
    r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
    r"|[^\W\d_]+|\d|[^\s\w]+",
    re.IGNORECASE | re.UNICODE)

_WS = re.compile(r"\s+")


def _clean(text: str) -> str:
    text = html.unescape(html.unescape(text))
    return _WS.sub(" ", text).strip().lower()


def _get_pairs(word: Tuple[str, ...]):
    return {(a, b) for a, b in zip(word, word[1:])}


class ClipTokenizer:
    """CLIP BPE tokenizer with HF-compatible call semantics."""

    def __init__(self, encoder: Dict[str, int],
                 bpe_ranks: Dict[Tuple[str, str], int]):
        self.encoder = dict(encoder)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.bpe_ranks = dict(bpe_ranks)
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.bos_id = self.encoder[BOS_TOKEN]
        self.eos_id = self.encoder[EOS_TOKEN]
        self.pad_id = self.eos_id  # HF CLIPTokenizer pads with <|endoftext|>
        self._cache: Dict[str, List[str]] = {}

    # ---- constructors ----

    @classmethod
    def from_files(cls, vocab_json: str, merges_txt: str) -> "ClipTokenizer":
        with open(vocab_json, encoding="utf-8") as f:
            encoder = json.load(f)
        with open(merges_txt, encoding="utf-8") as f:
            lines = f.read().split("\n")
        # standard merges.txt has a version header line
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#") and len(l.split()) == 2]
        ranks = {m: i for i, m in enumerate(merges)}
        return cls(encoder, ranks)

    @classmethod
    def fallback(cls) -> "ClipTokenizer":
        """Deterministic byte-level vocabulary, no merges.

        Ids: 0..255 byte symbols, 256..511 byte+'</w>' symbols, then specials
        at the canonical CLIP positions (bos 49406, eos 49407); the id space
        matches the real tokenizer so model embeddings are shape-compatible.
        """
        b2u = bytes_to_unicode()
        syms = [b2u[i] for i in range(256)]
        encoder = {}
        for i, s in enumerate(syms):
            encoder[s] = i
            encoder[s + "</w>"] = 256 + i
        encoder[BOS_TOKEN] = VOCAB_SIZE - 2
        encoder[EOS_TOKEN] = VOCAB_SIZE - 1
        return cls(encoder, {})

    @classmethod
    def load(cls, directory: Optional[str] = None) -> "ClipTokenizer":
        """Read vocab/merges from ``directory`` when both are there, else
        fall back to the byte-level vocabulary."""
        if directory:
            vj = os.path.join(directory, "vocab.json")
            mt = os.path.join(directory, "merges.txt")
            if os.path.isfile(vj) and os.path.isfile(mt):
                return cls.from_files(vj, mt)
        return cls.fallback()

    @property
    def vocab_size(self) -> int:
        return VOCAB_SIZE

    # ---- BPE core ----

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        if not self.bpe_ranks:
            out = list(word)
            self._cache[token] = out
            return out
        pairs = _get_pairs(word)
        if not pairs:
            return [token + "</w>"]
        while True:
            bigram = min(pairs,
                         key=lambda p: self.bpe_ranks.get(p, float("inf")))
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
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = list(word)
        self._cache[token] = out
        return out

    # ---- public API ----

    def tokenize(self, text: str) -> List[str]:
        toks: List[str] = []
        for piece in _PAT.findall(_clean(text)):
            piece = "".join(self.byte_encoder[b]
                            for b in piece.encode("utf-8"))
            toks.extend(self._bpe(piece))
        return toks

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        unk = self.eos_id
        ids = [self.encoder.get(t, unk) for t in self.tokenize(text)]
        if add_special_tokens:
            return [self.bos_id] + ids + [self.eos_id]
        return ids

    def decode(self, ids: Iterable[int],
               skip_special_tokens: bool = True) -> str:
        toks = []
        for i in ids:
            tok = self.decoder.get(int(i), "")
            if skip_special_tokens and tok in (BOS_TOKEN, EOS_TOKEN):
                continue
            toks.append(tok)
        text = "".join(toks).replace("</w>", " ")
        # byte-decode: map printable symbols back to bytes
        data = bytearray()
        for ch in text:
            if ch == " ":
                data.append(32)
            else:
                data.append(self.byte_decoder.get(ch, 32))
        return data.decode("utf-8", errors="replace").strip()

    def __call__(self, texts, max_length: int = 77,
                 padding: str = "max_length", truncation: bool = True):
        """HF ``batch_encode_plus``-style call (datasets.py:51): returns a
        dict of numpy ``input_ids`` and ``attention_mask``.

        Truncation matches HF: sequences longer than ``max_length`` are cut
        and terminated with <|endoftext|>.
        """
        if isinstance(texts, str):
            texts = [texts]
        batch_ids = []
        for t in texts:
            ids = self.encode(t)
            if truncation and len(ids) > max_length:
                ids = ids[:max_length - 1] + [self.eos_id]
            batch_ids.append(ids)
        if padding == "max_length":
            width = max_length
        else:
            width = max(len(i) for i in batch_ids)
        input_ids = np.full((len(batch_ids), width), self.pad_id,
                            dtype=np.int32)
        mask = np.zeros((len(batch_ids), width), dtype=np.int32)
        for r, ids in enumerate(batch_ids):
            input_ids[r, :len(ids)] = ids
            mask[r, :len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": mask}
