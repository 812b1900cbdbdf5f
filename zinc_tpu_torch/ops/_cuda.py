"""Build, load and count the port's CUDA kernels.

The sources in ``zinc_tpu_torch/csrc/`` are compiled by ``nvcc`` for
``sm_90a`` into shared libraries with a plain C interface, loaded with
``ctypes``: the field kernels (``FIELD_SOURCES``) once per field width,
``-DZT_WORDS=n32`` binding them to one word count, and the kernels that
take no field (``BLAKE3_SOURCES``: the BLAKE3 Merkle tree and the Zip
open's column records) once, as the ``BLAKE3`` target.
Each library is named by its target and a hash of the sources and flags,
in ``zinc_tpu_torch/_build/``.  A library is built at the first kernel call
on a CUDA tensor that needs it (never at import), or ahead by
:func:`build`; every nvcc process of every target asked for starts at
once.  ``BUILD[target]`` keeps each library's build time and each kernel's
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

from ..timing import timed

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
FIELD_SOURCES = ("mont_mul.cu", "sumcheck.cu", "generic.cu", "fs.cu", "eq.cu")
# the sources of the BLAKE3 target, which take no field
BLAKE3_SOURCES = ("blake3.cu", "zip_records.cu")
SOURCES = FIELD_SOURCES + BLAKE3_SOURCES
HEADERS = ("field.cuh", "generic.cuh", "round_eval.cuh", "round_sums.cuh", "keccak.cuh")
# the word counts the kernels take: n32 = 2·n64 for n64 = 1..8 (64 to 512 bits)
KERNEL_WORDS = tuple(range(2, 17, 2))

LAUNCHES = {"mont_mul": 0, "fold": 0, "round_eval": 0, "round_eval_gruen": 0,
            "round_eval_generic": 0, "fold_round_eval": 0, "fs_round": 0,
            "blake3_leaves": 0, "blake3_merge": 0, "eq_table": 0, "zip_records": 0}
# the target of BLAKE3_SOURCES, beside the field widths' targets (their n32)
BLAKE3 = "blake3"
# target -> {"seconds", "path", "cached", "ptxas"}
BUILD: dict = {}

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


def _sources(target) -> tuple[str, ...]:
    return BLAKE3_SOURCES if target == BLAKE3 else FIELD_SOURCES


def _defines(target) -> list[str]:
    """A field width's word count, or the BLAKE3 kernels' block and
    cluster, which ``ops/blake3.py`` plans its launches with (``LOG_BLOCK``,
    ``LOG_CLUSTER``)."""
    if target == BLAKE3:
        from .blake3 import LOG_BLOCK, LOG_CLUSTER

        return [f"-DZT_B3_LOG_BLOCK={LOG_BLOCK}", f"-DZT_B3_LOG_CLUSTER={LOG_CLUSTER}"]
    return [f"-DZT_WORDS={target}"]


def _lib_path(target) -> Path:
    h = hashlib.sha256(" ".join(_defines(target)).encode())
    for name in HEADERS + _sources(target):
        h.update((SRC_DIR / name).read_bytes())
    name = target if target == BLAKE3 else f"w{target}"
    return BUILD_DIR / f"libzinc_tpu_torch_{name}_{h.hexdigest()[:16]}.so"


def build(targets) -> None:
    """Build the libraries of these targets (word counts, or ``BLAKE3``) that
    are not on disk yet: one nvcc process per source and target, all started
    together, then one link per target."""
    for t in targets:
        if t != BLAKE3:
            require_kernel_words(t)
    todo = [t for t in dict.fromkeys(targets) if not _lib_path(t).exists()]
    for t in targets:
        if t not in todo and t not in BUILD:
            BUILD[t] = {"seconds": 0.0, "path": str(_lib_path(t)), "cached": True, "ptxas": ""}
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    pid = os.getpid()
    objs = {t: [_lib_path(t).with_suffix(f".{pid}.{Path(src).stem}.o") for src in _sources(t)]
            for t in todo}
    t0 = time.perf_counter()
    try:
        procs = {
            t: [subprocess.Popen([_nvcc(), *flags, *_defines(t), "-Xptxas", "-v", "-c",
                                  "-o", str(o), str(SRC_DIR / src)],
                                 stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                for src, o in zip(_sources(t), objs[t])]
            for t in todo
        }
        errs = {t: [p.communicate()[1] for p in ps] for t, ps in procs.items()}  # waits for all
        failed = [f"{src} for {t} ({p.returncode}):\n{err[-4000:]}"
                  for t in todo for src, p, err in zip(_sources(t), procs[t], errs[t])
                  if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmps = {t: _lib_path(t).with_suffix(f".{pid}.tmp") for t in todo}
        links = {t: subprocess.Popen([_nvcc(), *flags, "-shared", "-o", str(tmps[t]),
                                      *map(str, objs[t])],
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for t in todo}
        for t, p in links.items():
            err = p.communicate()[1]
            if p.returncode:
                raise RuntimeError(f"nvcc link failed for {t} ({p.returncode}):\n{err[-4000:]}")
    finally:
        for os_ in objs.values():
            for o in os_:
                o.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    for t in todo:
        os.replace(tmps[t], _lib_path(t))
        BUILD[t] = {"seconds": seconds, "path": str(_lib_path(t)), "cached": False,
                    "ptxas": "".join(errs[t])}


# each target's C entry points and their argument types (all return an int)
_FIELD_API = {
    "zt_mont_mul": [_P, _P, _P, _I64, _I, _P, _U32, _P],
    "zt_fold": [_P, _P, _I64, _I, _P, _P, _P, _U32, _P],
    "zt_eval_max_grid": [_I, _I, _I, _I, _P],
    "zt_round_eval": [_P, _P, _P, _P, _I64, _I64, _P, _P, _P, _I, _I, _I, _I, _I, _P, _U32, _P],
    "zt_gen_max_grid": [_I, _I, _I64, _I, _P],
    "zt_round_eval_generic": [_P, _P, _P, _P, _I, _I64, _P, _P, _I, _I, _I, _I, _I, _I, _P, _U32,
                              _P],
    "zt_fold_round_eval": [_P, _P, _P, _P, _P, _I, _I64, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                           _U32, _P],
    "zt_fs_round": [_P, _I, _P, _I, _I, _I, _P, _P, _P, _I, _P, _P, _I, _P, _U32, _P, _P, _I, _P],
    "zt_eq_table": [_P, _P, _I, _I, _I, _I, _P, _U32, _P, _P],
}
_BLAKE3_API = {
    "zt_blake3_leaves": [_P, _P, _I64, _I, _I, _I, _P],
    "zt_blake3_merge": [_P, _P, _I64, _I, _P],
    "zt_blake3_max_clusters": [_I, _P],
    "zt_zip_records": [_P, _P, _P, _P, _I64, _I64, _I64, _I, _I, _P],
}


def _load(target):
    l = _libs.get(target)
    if l is not None:
        return l
    with _lock:
        if target not in _libs:
            with timed("cuda.build"):
                build([target])
                l = ctypes.CDLL(BUILD[target]["path"])
            for name, args in (_BLAKE3_API if target == BLAKE3 else _FIELD_API).items():
                fn = getattr(l, name)
                fn.argtypes, fn.restype = args, _I
            _libs[target] = l
    return _libs[target]


def lib(n32: int):
    """The loaded field-kernel library of this word count (built on first use)."""
    return _load(n32)


def blake3_lib():
    """The loaded library of the kernels that take no field, the BLAKE3
    tree's and the column records' (built on first use)."""
    return _load(BLAKE3)


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


@functools.lru_cache(maxsize=32)
def one_words(ctx) -> np.ndarray:
    """``host_words`` of a field's 1̂ = R mod q (one in Montgomery form)."""
    return host_words(ctx.one)


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
