"""Build, load and count the port's CUDA kernels.

The sources in ``zinc_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` once per field width: ``-DZT_WORDS=n32`` binds the kernels to one
word count, and each width is its own shared library with a plain C
interface, named by the width and a hash of the sources, in
``zinc_tpu_torch/_build/``, loaded with ``ctypes``.  A width is built at the
first kernel call on a CUDA tensor of that width (never at import), or ahead
by :func:`build`; every nvcc process of every width asked for starts at
once.  ``BUILD[n32]`` keeps each width's build time and each kernel's
register and spill report (``-Xptxas -v``).  Every C entry point returns
``cudaGetLastError()``; :func:`check` raises when it is not 0.

``LAUNCHES`` counts kernel launches per kernel (over all widths); a wrapper
adds one where it launches its kernel and nowhere else.  A wrapper launches
on its tensors' card, made current for the call (:func:`on_device`), on that
card's current stream (:func:`stream_ptr`), and raises when its tensors lie
on different devices.
"""

from __future__ import annotations

import ctypes
import functools
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
SOURCES = ("mont_mul.cu", "sumcheck.cu", "generic.cu", "fs.cu")
HEADERS = ("field.cuh", "generic.cuh", "round_eval.cuh", "round_sums.cuh", "keccak.cuh")
# the word counts the kernels take: n32 = 2·n64 for n64 = 1..8 (64 to 512 bits)
KERNEL_WORDS = tuple(range(2, 17, 2))

LAUNCHES = {"mont_mul": 0, "fold": 0, "round_eval": 0, "round_eval_gruen": 0,
            "round_eval_generic": 0, "fold_round_eval": 0, "fs_round": 0}
# n32 -> {"seconds", "path", "cached", "ptxas"}
BUILD: dict[int, dict] = {}

_lock = threading.Lock()
_libs: dict = {}

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


def _lib_path(n32: int) -> Path:
    h = hashlib.sha256()
    for name in HEADERS + SOURCES:
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libzinc_tpu_torch_w{n32}_{h.hexdigest()[:16]}.so"


def build(widths) -> None:
    """Build the libraries of these word counts that are not on disk yet: one
    nvcc process per source and width, all started together, then one link
    per width."""
    for n32 in widths:
        require_kernel_words(n32)
    todo = sorted({n for n in widths if not _lib_path(n).exists()})
    for n in widths:
        if n not in todo and n not in BUILD:
            BUILD[n] = {"seconds": 0.0, "path": str(_lib_path(n)), "cached": True, "ptxas": ""}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    pid = os.getpid()
    objs = {n: [_lib_path(n).with_suffix(f".{pid}.{Path(src).stem}.o") for src in SOURCES]
            for n in todo}
    t0 = time.perf_counter()
    try:
        procs = {
            n: [subprocess.Popen([_nvcc(), *flags, f"-DZT_WORDS={n}", "-Xptxas", "-v", "-c",
                                  "-o", str(o), str(SRC_DIR / src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, o in zip(SOURCES, objs[n])]
            for n in todo
        }
        errs = {n: [p.communicate()[1] for p in ps] for n, ps in procs.items()}  # waits for all
        failed = [f"{src} at {n} words ({p.returncode}):\n{err[-4000:]}"
                  for n in todo for src, p, err in zip(SOURCES, procs[n], errs[n]) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmps = {n: _lib_path(n).with_suffix(f".{pid}.tmp") for n in todo}
        links = {n: subprocess.Popen([_nvcc(), *flags, "-shared", "-o", str(tmps[n]),
                                      *map(str, objs[n])],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for n in todo}
        for n, p in links.items():
            err = p.communicate()[1]
            if p.returncode:
                raise RuntimeError(f"nvcc link failed at {n} words ({p.returncode}):\n{err[-4000:]}")
    finally:
        for os_ in objs.values():
            for o in os_:
                o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    for n in todo:
        os.replace(tmps[n], _lib_path(n))
        BUILD[n] = {"seconds": seconds, "path": str(_lib_path(n)), "cached": False,
                    "ptxas": "".join(errs[n])}


def lib(n32: int):
    """The loaded kernel library of this word count (built on first use)."""
    l = _libs.get(n32)
    if l is not None:
        return l
    with _lock:
        if n32 not in _libs:
            build([n32])
            l = ctypes.CDLL(BUILD[n32]["path"])
            l.zt_mont_mul.argtypes = [_P, _P, _P, _I64, _I, _P, _U32, _P]
            l.zt_fold.argtypes = [_P, _P, _I64, _I, _P, _P, _P, _U32, _P]
            l.zt_eval_max_grid.argtypes = [_I, _I, _I, _I, _P]
            l.zt_round_eval.argtypes = [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _I, _I, _I, _I, _I,
                                        _P, _U32, _P]
            l.zt_gen_max_grid.argtypes = [_I, _I, _I64, _I, _P]
            l.zt_round_eval_generic.argtypes = [_P, _P, _P, _P, _I, _I64, _P, _P, _I, _I, _I, _I, _I,
                                                _I, _P, _U32, _P]
            l.zt_fold_round_eval.argtypes = [_P, _P, _P, _P, _P, _I, _I64, _P, _P, _P, _P, _I, _I,
                                             _I, _I, _I, _I, _P, _U32, _P]
            l.zt_fs_round.argtypes = [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _U32,
                                      _P, _I, _P]
            for fn in (l.zt_mont_mul, l.zt_fold, l.zt_eval_max_grid, l.zt_round_eval,
                       l.zt_gen_max_grid, l.zt_round_eval_generic, l.zt_fold_round_eval,
                       l.zt_fs_round):
                fn.restype = _I
            _libs[n32] = l
    return _libs[n32]


def target_device(device) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for the CPU.  Raises when a CUDA device is asked for and there is none;
    nothing falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")


def on_device(x: torch.Tensor):
    """The context a launch on ``x``'s card runs in: that card is current, so
    the library's ``cudaGetDevice``, occupancy probes and per-device
    attributes (``csrc/generic.cuh:prepare_smem``) act on it."""
    return torch.cuda.device(x.device)


def stream_ptr(device: torch.device) -> int:
    """The current stream of ``device``, the one its launches go on."""
    return torch.cuda.current_stream(device).cuda_stream


def host_words(words: np.ndarray) -> np.ndarray:
    """Contiguous uint32 copy whose ``.ctypes.data`` a C call may read."""
    return np.ascontiguousarray(np.asarray(words, dtype=np.uint32))


@functools.lru_cache(maxsize=32)
def modulus_words(ctx) -> np.ndarray:
    """``host_words`` of a field's modulus, made once per field."""
    return host_words(ctx.q)


@functools.lru_cache(maxsize=32)
def r2_words(ctx) -> np.ndarray:
    """``host_words`` of a field's R² mod q (Montgomery's conversion factor)."""
    return host_words(ctx.r2)


def require_field_tensor(name: str, x: torch.Tensor, n32: int, ndim: int) -> None:
    """Raise unless ``x`` is a contiguous int32 (…, n32) tensor of rank ndim."""
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected torch.int32 words, got {x.dtype}")
    if x.dim() != ndim or x.shape[-1] != n32:
        raise ValueError(f"{name}: expected rank {ndim} with last dim {n32}, got {tuple(x.shape)}")
    if x.is_cuda and (not x.is_contiguous() or x.data_ptr() % vector_bytes(n32)):
        raise ValueError(f"{name}: CUDA input must be contiguous and {vector_bytes(n32)}-byte aligned")


def vector_bytes(n32: int) -> int:
    """The kernels load an element as 16-byte vectors, or 8-byte ones when
    its word count is not a multiple of 4."""
    return 16 if n32 % 4 == 0 else 8


def require_kernel_words(n32: int) -> None:
    if n32 not in KERNEL_WORDS:
        raise ValueError(f"no CUDA kernel for {n32} words (supported: {KERNEL_WORDS})")
