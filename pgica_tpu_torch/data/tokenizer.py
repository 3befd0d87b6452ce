"""Byte-level BPE caption tokenizer (port's copy of pgica_tpu/data/tokenizer.py).

The port keeps its own copy so that it never imports the JAX package; the
ids, the special tokens, ``decode``, ``save`` and the merges ``train_bpe``
learns are the same, and tests/test_torch_ops.py and
tests/test_torch_native_bpe.py hold the two against each other.

Modes, all offline: local GPT-2-style ``vocab.json`` + ``merges.txt``
artifacts, a byte-level BPE trained on a caption corpus (``train_bpe``), or
the byte fallback (256 byte tokens + specials). Special tokens
([PAD]/[UNK]/[BOS]/[EOS]/[SEP]) are appended after the base vocabulary in a
fixed order so every component sees identical ids.

``encode`` goes through the native encoder (``data/native_bpe.py``, the
repository's ``native/bpe.cpp``) where it builds, else through the
pure-Python path, the reference; both give the same ids. The native handle
is process-local: a pickled tokenizer (a worker process's copy) leaves it
behind and builds its own.
"""

from __future__ import annotations

import json
import re
from collections import Counter
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np

from pgica_tpu_torch.data._unicode_classes import LETTER_RANGES, NUMBER_RANGES
from pgica_tpu_torch.data.native_bpe import NativeBPE

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
        self._base_vocab = dict(vocab)
        self._merges = list(merges or [])
        self._merge_ranks = {pair: i for i, pair in enumerate(self._merges)}
        self.vocab: Dict[str, int] = dict(vocab)
        base = max(self.vocab.values()) + 1 if self.vocab else 0
        for i, tok in enumerate(SPECIAL_TOKENS):
            if tok not in self.vocab:
                self.vocab[tok] = base + i
        self.id_to_token = {i: t for t, i in self.vocab.items()}
        self._cache: Dict[str, List[str]] = {}
        self._native = None  # the native encoder, built at the first encode (data/native_bpe.py)
        self._native_tried = False

    def __getstate__(self):
        """Picklable for worker processes: the native encoder's ctypes handle is process-local, so
        the copy leaves it (and the word cache) behind and builds its own at its first encode."""
        state = self.__dict__.copy()
        state.update(_native=None, _native_tried=False, _cache={})
        return state

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

    def _native_encoder(self):
        """The native encoder, or None where the library does not build."""
        if not self._native_tried:
            self._native_tried = True
            candidate = NativeBPE(self.vocab, self._merges, self.unk_token_id)
            self._native = candidate if candidate.available else None
        return self._native

    def _python_encode(self, text: str) -> List[int]:
        """The pure-Python path, the reference the native encoder is held to."""
        unk = self.unk_token_id
        return [self.vocab.get(sym, unk) for piece in _pretokenize(text) for sym in self._bpe(piece)]

    def encode(self, text: str, add_bos: bool = False, add_eos: bool = False) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_bos else []
        native = self._native_encoder()
        body = native.encode(text) if native is not None else None
        ids.extend(self._python_encode(text) if body is None else body)
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

    def save(self, directory: Union[str, Path]) -> None:
        """``vocab.json`` (the base vocabulary, without the specials) and ``merges.txt``, as the JAX package writes them."""
        directory = Path(directory)
        directory.mkdir(parents=True, exist_ok=True)
        with open(directory / "vocab.json", "w") as f:
            json.dump(self._base_vocab, f, ensure_ascii=False)
        with open(directory / "merges.txt", "w") as f:
            f.write("#version: pgica_tpu\n")
            for a, b in self._merges:
                f.write(f"{a} {b}\n")

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

    @classmethod
    def train_bpe(cls, corpus: Iterable[str], vocab_size: int = 8192, min_frequency: int = 2) -> "CaptionTokenizer":
        """Train a byte-level BPE on caption text (JAX tokenizer.py:295-342): from the 256 byte
        symbols, merge the most frequent adjacent pair (the first met on a tie) until the vocab
        holds ``vocab_size`` entries with the specials, or no pair occurs ``min_frequency`` times."""
        word_freq: Counter = Counter()
        for text in corpus:
            word_freq.update(_pretokenize(text))
        words: Dict[Tuple[str, ...], int] = {}
        for w, f in word_freq.items():
            sym = tuple(_BYTE_ENCODER[b] for b in w.encode("utf-8"))
            words[sym] = words.get(sym, 0) + f

        vocab = {_BYTE_ENCODER[b]: b for b in range(256)}
        merges: List[Tuple[str, str]] = []
        for _ in range(max(0, vocab_size - 256 - len(SPECIAL_TOKENS))):
            pair_freq: Counter = Counter()
            for sym, f in words.items():
                for i in range(len(sym) - 1):
                    pair_freq[(sym[i], sym[i + 1])] += f
            if not pair_freq:
                break
            best, freq = pair_freq.most_common(1)[0]
            if freq < min_frequency:
                break
            merges.append(best)
            first, second = best
            joined = first + second
            new_words: Dict[Tuple[str, ...], int] = {}
            for sym, f in words.items():
                out: List[str] = []
                i = 0
                while i < len(sym):
                    if i < len(sym) - 1 and sym[i] == first and sym[i + 1] == second:
                        out.append(joined)
                        i += 2
                    else:
                        out.append(sym[i])
                        i += 1
                t = tuple(out)
                new_words[t] = new_words.get(t, 0) + f
            words = new_words
            vocab[joined] = len(vocab)
        return cls(vocab=vocab, merges=merges)
