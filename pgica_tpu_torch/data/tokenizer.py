"""Byte-level BPE caption tokenizer (port's copy of pgica_tpu/data/tokenizer.py).

The port keeps its own copy so that it never imports the JAX package; the
ids, the special tokens and ``decode`` are the same, and
tests/test_torch_ops.py holds the two against each other. Left out: the
native C++ encoder hook (``native_bpe``) and ``train_bpe`` (ROADMAP queue 1
item 4): captions encode through the pure-Python path, which gives the same
ids.

Modes, all offline: local GPT-2-style ``vocab.json`` + ``merges.txt``
artifacts, or the byte fallback (256 byte tokens + specials). Special tokens
([PAD]/[UNK]/[BOS]/[EOS]/[SEP]) are appended after the base vocabulary in a
fixed order so every component sees identical ids.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from pgica_tpu_torch.data._unicode_classes import LETTER_RANGES, NUMBER_RANGES

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[BOS]", "[EOS]", "[SEP]")


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible byte<->unicode map (printable surrogate alphabet)."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


_BYTE_ENCODER = _bytes_to_unicode()
_BYTE_DECODER = {v: k for k, v in _BYTE_ENCODER.items()}


def _char_class(ranges) -> str:
    parts = []
    for a, b in ranges:
        if b > a:
            parts.append(f"{re.escape(chr(a))}-{re.escape(chr(b))}")
        else:
            parts.append(re.escape(chr(a)))
    return "".join(parts)


_L = _char_class(LETTER_RANGES)
_N = _char_class(NUMBER_RANGES)

# GPT-2's exact pretokenizer pattern with \p{L}/\p{N} expanded from the
# generated Unicode tables.
_PRETOKEN_RE = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d"
    rf"| ?[{_L}]+"
    rf"| ?[{_N}]+"
    rf"| ?[^\s{_L}{_N}]+"
    r"|\s+(?!\S)|\s+"
)


def _pretokenize(text: str) -> List[str]:
    return _PRETOKEN_RE.findall(text)


class CaptionTokenizer:
    """Byte-level BPE tokenizer with appended special tokens."""

    def __init__(
        self,
        vocab: Optional[Dict[str, int]] = None,
        merges: Optional[List[Tuple[str, str]]] = None,
    ):
        if vocab is None:
            # Byte-fallback vocabulary: the 256 byte-alphabet symbols.
            vocab = {_BYTE_ENCODER[b]: b for b in range(256)}
            merges = []
        self._merge_ranks = {pair: i for i, pair in enumerate(merges or [])}
        self.vocab: Dict[str, int] = dict(vocab)
        base = max(self.vocab.values()) + 1 if self.vocab else 0
        for i, tok in enumerate(SPECIAL_TOKENS):
            if tok not in self.vocab:
                self.vocab[tok] = base + i
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: Dict[str, List[str]] = {}

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    @property
    def pad_token_id(self) -> int:
        return self.vocab["[PAD]"]

    @property
    def unk_token_id(self) -> int:
        return self.vocab["[UNK]"]

    @property
    def bos_token_id(self) -> int:
        return self.vocab["[BOS]"]

    @property
    def eos_token_id(self) -> int:
        return self.vocab["[EOS]"]

    @property
    def sep_token_id(self) -> int:
        return self.vocab["[SEP]"]

    def _bpe(self, token: str) -> List[str]:
        if token in self._cache:
            return self._cache[token]
        word = [_BYTE_ENCODER[b] for b in token.encode("utf-8")]
        while self._merge_ranks and len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs, key=lambda p: self._merge_ranks.get(p, float("inf")))
            if best not in self._merge_ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = merged
        self._cache[token] = word
        return word

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        unk = self.unk_token_id
        for piece in _pretokenize(text):
            ids.extend(self.vocab.get(sym, unk) for sym in self._bpe(piece))
        if add_eos:
            ids.append(self.eos_token_id)
        return ids

    def decode(self, ids: Sequence[int], skip_special_tokens: bool = True) -> str:
        special_ids = {self.vocab[t] for t in SPECIAL_TOKENS}
        symbols: List[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in special_ids:
                continue
            tok = self.id_to_token.get(i)
            if tok is None or tok in SPECIAL_TOKENS:
                continue
            symbols.append(tok)
        raw = "".join(symbols)
        data = bytes(_BYTE_DECODER[c] for c in raw if c in _BYTE_DECODER)
        return data.decode("utf-8", errors="replace")

    def encode_padded(
        self, text: str, max_length: int, add_bos: bool = True, add_eos: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode to fixed length; returns (ids[int32], mask[int32])."""
        ids = self.encode(text, add_bos=add_bos, add_eos=False)
        if add_eos:
            ids = ids[: max_length - 1] + [self.eos_token_id]
        else:
            ids = ids[:max_length]
        mask = np.zeros((max_length,), np.int32)
        mask[: len(ids)] = 1
        out = np.full((max_length,), self.pad_token_id, np.int32)
        out[: len(ids)] = ids
        return out, mask

    def encode_batch(
        self, texts: Sequence[str], max_length: int, add_bos: bool = True, add_eos: bool = True
    ) -> Tuple[np.ndarray, np.ndarray]:
        pairs = [self.encode_padded(t, max_length, add_bos, add_eos) for t in texts]
        return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])

    @classmethod
    def load(cls, directory: Union[str, Path]) -> "CaptionTokenizer":
        directory = Path(directory)
        with open(directory / "vocab.json") as f:
            vocab = json.load(f)
        merges: List[Tuple[str, str]] = []
        merges_path = directory / "merges.txt"
        if merges_path.exists():
            for line in merges_path.read_text().splitlines():
                if line.startswith("#") or not line.strip():
                    continue
                a, _, b = line.partition(" ")
                merges.append((a, b.strip()))
        return cls(vocab=vocab, merges=merges)

    @classmethod
    def from_pretrained(cls, name_or_path: Union[str, Path]) -> "CaptionTokenizer":
        """Local GPT-2-style artifacts if ``name_or_path`` is such a directory,
        else the byte fallback (model *names* like "gpt2-medium" resolve to
        it offline)."""
        path = Path(str(name_or_path))
        if path.is_dir() and (path / "vocab.json").exists():
            return cls.load(path)
        return cls()
