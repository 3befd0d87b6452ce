"""Build, load and count the port's hand-written CUDA kernels.

Each source in ``pgica_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library of its own with a plain C interface (no
PyTorch headers, so a build takes seconds) and loaded with ``ctypes``; one
source may hold several kernels' entry points. The build runs at first use —
the first kernel launch builds every library, one ``nvcc`` process per
source, all started together — into ``build/pgica_tpu_torch/`` at the root of
the checkout (git-ignored). Each library's file name carries a hash of its
source, the shared headers and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is.

Every wrapper calls :func:`launch`, which raises if the C entry point returns a
CUDA error and otherwise adds one to the kernel's launch count; the counts
show that a run really went through the kernels. An entry point that holds
several kernels may count the one it took as well (``ROUTES``): the f32
flash forward's register-tiled instance counts as ``flash_attn_fwd`` and as
``flash_attn_fwd_f32``.

Nothing here runs at import: the CPU tests import every module, and this host
may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "pgica_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# kernel name -> (source file, C entry point, argtypes)
KERNELS = {
    "layernorm_fwd": (
        "layernorm_fwd.cu", "pgica_layernorm_fwd",
        (_P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _P),
    ),
    "flash_attn_fwd": (
        "flash_attn_fwd.cu", "pgica_flash_attn_fwd",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _I, _P),
    ),
    "layernorm_bwd": (
        "layernorm_bwd.cu", "pgica_layernorm_bwd",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    ),
    "flash_attn_bwd_dq": (
        "flash_attn_bwd.cu", "pgica_flash_attn_bwd_dq",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    ),
    "flash_attn_bwd_dkv": (
        "flash_attn_bwd.cu", "pgica_flash_attn_bwd_dkv",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P),
    ),
    "fused_ce_fwd": (
        "fused_ce.cu", "pgica_fused_ce_fwd",
        (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    ),
    "fused_ce_bwd_dh": (
        "fused_ce_bwd.cu", "pgica_fused_ce_bwd_dh",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    ),
    "fused_ce_bwd_dw": (
        "fused_ce_bwd.cu", "pgica_fused_ce_bwd_dw",
        (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    ),
    "rmsnorm_fwd": (
        "rmsnorm_fwd.cu", "pgica_rmsnorm_fwd",
        (_P, _P, _P, _P, _I, _I, _F, _I, _P),
    ),
    "rmsnorm_bwd": (
        "rmsnorm_bwd.cu", "pgica_rmsnorm_bwd",
        (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    ),
    "q8_matmul_w8a8": (
        "q8_matmul.cu", "pgica_q8_matmul_w8a8",
        (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    ),
    "q8_matmul_w8": (
        "q8_matmul.cu", "pgica_q8_matmul_w8",
        (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    ),
}
SOURCES = sorted({source for source, _, _ in KERNELS.values()})
# counts of a kernel inside an entry point, beside the entry point's own
ROUTES = ("flash_attn_fwd_f32",)

_launches: Dict[str, int] = {name: 0 for name in (*KERNELS, *ROUTES)}
_entry_points: Dict[str, Callable[..., int]] = {}
_error_strings: Dict[str, Callable[[int], bytes]] = {}


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def library_path(source: str) -> Path:
    digest = hashlib.sha256()
    for part in (CSRC / source, *sorted(CSRC.glob("*.cuh"))):
        digest.update(part.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(source).stem}-{digest.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit's nvcc")


def build() -> Dict[str, float]:
    """Compile every kernel library that is not built yet, all at once.

    Returns seconds per source built (empty if all were present). The
    compiler's report (``-Xptxas -v``: registers, shared memory, spills) is
    kept beside each library as ``<source stem>-<hash>.log``.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = []
    for source in SOURCES:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started.append((source, out, tmp, proc, time.perf_counter()))
    seconds = {}
    for source, out, tmp, proc, t0 in started:
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {source} (exit {proc.returncode}):\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return seconds


def c_function(source: str, symbol: str, argtypes) -> Callable[..., int]:
    """A C function of ``source``'s library (built if it is not yet), returning an int; not counted as a launch."""
    build()
    fn = getattr(ctypes.CDLL(str(library_path(source))), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


def _entry_point(name: str):
    fn = _entry_points.get(name)
    if fn is None:
        source, symbol, argtypes = KERNELS[name]
        fn = c_function(source, symbol, argtypes)
        err = c_function(source, "pgica_error_string", (ctypes.c_int,))
        err.restype = ctypes.c_char_p
        _entry_points[name], _error_strings[name] = fn, err
    return fn


def launch(name: str, *args, route: Optional[str] = None) -> None:
    """Call kernel ``name``'s C entry point; raise on a CUDA error, count on success (``route``, one of
    ``ROUTES``: the kernel the entry point takes for these arguments, counted besides)."""
    rc = _entry_point(name)(*args)
    if rc != 0:
        msg = _error_strings[name](rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
    _launches[name] += 1
    if route is not None:
        _launches[route] += 1


def stream_handle(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
