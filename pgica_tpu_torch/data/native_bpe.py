"""ctypes binding of the native BPE encoder (the port's copy of pgica_tpu/data/native_bpe.py).

The repository's ``native/bpe.cpp`` (with ``native/unicode_classes.h``)
encodes text with the tokenizer's pretokenizer, byte alphabet and merge
ranks, and gives the same ids as the pure-Python path in
``data/tokenizer.py`` for every input. It is built with ``g++`` on first use
into the port's git-ignored build directory,
``build/pgica_tpu_torch/native/``, under a name that carries a hash of the
sources and the flags, so an edited source is rebuilt. Where it does not
build (no compiler), :class:`NativeBPE` is unavailable and ``encode``
returns None: the caller then encodes in Python, which gives the same ids.
This is a host encoder, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "bpe.cpp"
_HEADER = _SOURCE.parent / "unicode_classes.h"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgica_tpu_torch" / "native"
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
build_error: Optional[str] = None  # why the library did not build, when it did not


def _library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes() + _HEADER.read_bytes() + " ".join(_FLAGS).encode())
    return _BUILD_DIR / f"libbpe-{digest.hexdigest()[:12]}.so"


def _build_library(path: Path) -> bool:
    global build_error
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")  # worker processes may build at once
    cmd = ["g++", *_FLAGS, str(_SOURCE), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        lines = (getattr(e, "stderr", None) or b"").decode(errors="replace").splitlines()
        build_error = next((line.strip() for line in lines if "error" in line), str(e))
        logger.info("native BPE encoder not built (%s); captions encode in Python", build_error)
        return False
    tmp.replace(path)
    return True


def get_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not (_SOURCE.exists() and _HEADER.exists()):
        return None
    path = _library_path()
    if not path.exists() and not _build_library(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.bpe_new.argtypes = []
        lib.bpe_new.restype = ctypes.c_void_p
        lib.bpe_free.argtypes = [ctypes.c_void_p]
        lib.bpe_free.restype = None
        lib.bpe_add_token.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32]
        lib.bpe_add_token.restype = None
        lib.bpe_add_merge.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int32]
        lib.bpe_add_merge.restype = None
        lib.bpe_set_unk.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.bpe_set_unk.restype = None
        lib.bpe_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int32]
        lib.bpe_encode.restype = ctypes.c_int32
        _lib = lib
    except OSError as e:
        logger.info("native BPE encoder not loaded (%s); captions encode in Python", e)
    return _lib


class NativeBPE:
    """A configured native encoder: the vocab, the merges in rank order and the unknown id.

    Process-local (a ctypes handle): a tokenizer sent to a worker process
    leaves it behind and builds its own there (``CaptionTokenizer.__getstate__``).
    """

    def __init__(self, vocab: dict, merges: Sequence[Tuple[str, str]], unk_id: int):
        self._lib = get_library()
        self._handle = None
        if self._lib is None:
            return
        handle = self._lib.bpe_new()
        for sym, idx in vocab.items():
            self._lib.bpe_add_token(handle, sym.encode("utf-8"), int(idx))
        for rank, (a, b) in enumerate(merges):
            self._lib.bpe_add_merge(handle, a.encode("utf-8"), b.encode("utf-8"), rank)
        self._lib.bpe_set_unk(handle, int(unk_id))
        self._handle = handle

    @property
    def available(self) -> bool:
        return self._handle is not None

    def encode(self, text: str, max_tokens: int = 4096) -> Optional[List[int]]:
        """The ids of ``text``, or None when the library is unavailable or the text takes more
        than ``max_tokens`` ids (the caller then encodes in Python)."""
        if self._handle is None:
            return None
        buf = (ctypes.c_int32 * max_tokens)()
        n = self._lib.bpe_encode(self._handle, text.encode("utf-8"), buf, max_tokens)
        if n > max_tokens:
            return None
        return list(buf[:n])

    def __del__(self):
        if getattr(self, "_handle", None) is not None and self._lib is not None:
            self._lib.bpe_free(self._handle)
            self._handle = None
