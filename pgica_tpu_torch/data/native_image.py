"""ctypes binding of the native JPEG decode + resize (the port's copy of pgica_tpu/data/native_image.py).

The repository's ``native/image.cpp`` decodes JPEG bytes with libjpeg and
resizes them with a Pillow-BILINEAR-equivalent triangle filter in one call
(``prescale``: libjpeg's DCT-domain downscale first, as Pillow's ``draft``).
It is built with ``g++`` on first use into the port's git-ignored build
directory, ``build/pgica_tpu_torch/native/``, under a name that carries a
hash of the source and the flags. Where it does not build (no compiler, no
libjpeg headers) or a JPEG is rejected (CMYK, corrupt), the functions return
None and the caller decodes with PIL (``ImageProcessor``). This is a host
decoder, not a device kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

logger = logging.getLogger(__name__)

_SOURCE = Path(__file__).resolve().parents[2] / "native" / "image.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgica_tpu_torch" / "native"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None
_load_attempted = False
build_error: Optional[str] = None  # why the library did not build, when it did not


def _library_path() -> Path:
    digest = hashlib.sha1(_SOURCE.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()[:12]
    return _BUILD_DIR / f"libimage-{digest}.so"


def _build_library(path: Path) -> bool:
    global build_error
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp.so")  # worker processes may build at once
    cmd = ["g++", *_FLAGS, str(_SOURCE), "-ljpeg", "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError) as e:
        lines = (getattr(e, "stderr", None) or b"").decode(errors="replace").splitlines()
        build_error = next((line.strip() for line in lines if "error" in line), str(e))
        logger.info("native image decoder not built (%s); JPEGs decode with PIL", build_error)
        return False
    tmp.replace(path)
    return True


def get_library() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    _load_attempted = True
    if not _SOURCE.exists():
        return None
    path = _library_path()
    if not path.exists() and not _build_library(path):
        return None
    try:
        lib = ctypes.CDLL(str(path))
        lib.pgica_decode_resize_jpeg.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.pgica_decode_resize_jpeg.restype = ctypes.c_int
        _lib = lib
    except OSError as e:
        logger.info("native image decoder not loaded (%s); JPEGs decode with PIL", e)
    return _lib


def decode_resize_jpeg(data: bytes, size: int, prescale: bool = False) -> Optional[np.ndarray]:
    """JPEG bytes -> (size, size, 3) u8 RGB, or None (the caller falls back to PIL)."""
    lib = get_library()
    if lib is None:
        return None
    out = np.empty((size, size, 3), np.uint8)
    rc = lib.pgica_decode_resize_jpeg(data, len(data), size, int(prescale),
                                      out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out if rc == 0 else None

