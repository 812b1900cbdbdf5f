"""Build, load and count the port's CUDA kernels.

The sources in ``zinc_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a``, one process per source, all started together, and linked into
one shared library with a plain C interface, at the first kernel call (never
at import), into ``zinc_tpu_torch/_build/`` under a name that hashes the
sources, and loaded with ``ctypes``.  ``BUILD["ptxas"]`` keeps each
kernel's register and spill report (``-Xptxas -v``).  Every C entry point
returns ``cudaGetLastError()``; :func:`check` raises when it is not 0.

``LAUNCHES`` counts kernel launches per kernel; a wrapper adds one where it
launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("mont_mul.cu", "sumcheck.cu", "generic.cu")
HEADERS = ("field.cuh", "generic.cuh")

LAUNCHES = {"mont_mul": 0, "fold": 0, "round_eval": 0, "round_eval_gruen": 0,
            "round_eval_generic": 0, "fold_round_eval": 0}
BUILD = {"seconds": None, "path": None, "cached": None, "ptxas": ""}

_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
_U32 = ctypes.c_uint32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def _build() -> Path:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"libzinc_tpu_torch_{_digest()}.so"
    if out.exists():
        BUILD.update(seconds=0.0, path=str(out), cached=True)
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objs = [out.with_suffix(f".{os.getpid()}.{Path(src).stem}.o") for src in SOURCES]
    t0 = time.perf_counter()
    try:
        procs = [
            subprocess.Popen([_nvcc(), *flags, "-Xptxas", "-v", "-c", "-o", str(o), str(SRC_DIR / src)],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for src, o in zip(SOURCES, objs)
        ]
        errs = [p.communicate()[1] for p in procs]  # waits for every compile
        failed = [f"{src} ({p.returncode}):\n{err[-4000:]}"
                  for src, p, err in zip(SOURCES, procs, errs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run([_nvcc(), *flags, "-shared", "-o", str(tmp), *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    BUILD.update(seconds=time.perf_counter() - t0, path=str(out), cached=False, ptxas="".join(errs))
    return out


def lib():
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            l = ctypes.CDLL(str(_build()))
            l.zt_mont_mul.argtypes = [_P, _P, _P, _I64, _I, _P, _U32, _P]
            l.zt_fold.argtypes = [_P, _P, _I64, _I, _P, _P, _U32, _P]
            l.zt_eval_blocks.argtypes = [_I64]
            l.zt_round_eval.argtypes = [_P, _P, _I64, _I64, _P, _I, _I, _I, _P, _U32, _P]
            l.zt_round_eval_gruen.argtypes = [_P, _P, _I64, _I64, _P, _P, _I, _I, _I, _P, _U32, _P]
            l.zt_gen_blocks.argtypes = [_I64]
            l.zt_round_eval_generic.argtypes = [_P, _P, _I64, _I64, _P, _P, _I, _I, _I, _P, _U32, _P]
            l.zt_fold_round_eval.argtypes = [_P, _P, _P, _I, _I64, _P, _P, _P, _I, _I, _I, _P,
                                             _U32, _P]
            for fn in (l.zt_mont_mul, l.zt_fold, l.zt_eval_blocks, l.zt_round_eval,
                       l.zt_round_eval_gruen, l.zt_gen_blocks, l.zt_round_eval_generic,
                       l.zt_fold_round_eval):
                fn.restype = _I
            _lib = l
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream


def host_words(words: np.ndarray) -> np.ndarray:
    """Contiguous uint32 copy whose ``.ctypes.data`` a C call may read."""
    return np.ascontiguousarray(np.asarray(words, dtype=np.uint32))


def require_field_tensor(name: str, x: torch.Tensor, n32: int, ndim: int) -> None:
    """Raise unless ``x`` is a contiguous int32 (…, n32) tensor of rank ndim."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 words, got {x.dtype}")
    if x.dim() != ndim or x.shape[-1] != n32:
        raise ValueError(f"{name}: expected rank {ndim} with last dim {n32}, got {tuple(x.shape)}")
    if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % 16):
        raise ValueError(f"{name}: CUDA input must be contiguous and 16-byte aligned")


def require_kernel_words(n32: int) -> None:
    from ..fields.montgomery import KERNEL_WORDS

    if n32 not in KERNEL_WORDS:
        raise ValueError(f"no CUDA kernel for {n32} words (supported: {KERNEL_WORDS})")
