"""Loader for the port's native host runtime (``csrc/zinc_native.cpp``).

Compiles the C++ translation unit into a shared library on first use (g++,
no external deps) under ``_build/``, named by a hash of the source, and
exposes it through ctypes.  Everything that uses it falls back to the
pure-Python implementations when the toolchain is missing, so the package
stays importable anywhere; with the library present the host-side hashing
hot paths (Fiat-Shamir Keccak, Merkle BLAKE3) run at native speed.
``ZINC_TPU_NATIVE_THREADS`` sets the runtime's thread count (read per call),
``ZINC_TPU_NO_NATIVE`` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "csrc", "zinc_native.cpp")
_BUILD_DIR = os.path.join(_PKG, "_build")

_lock = threading.Lock()
_lib = None
_tried = False


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libzinc_native_{digest}.so")


def _build(out: str) -> bool:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
        "-pthread", "-o", tmp, _SRC,
    ]
    try:
        res = subprocess.run(cmd, capture_output=True, timeout=240)
        if res.returncode != 0:
            return False
        os.replace(tmp, out)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False


def get_lib():
    """The ctypes library handle, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("ZINC_TPU_NO_NATIVE"):
            return None
        if not os.path.exists(_SRC):
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        u64p = ctypes.POINTER(ctypes.c_uint64)
        lib.zn_keccak_absorb_blocks.argtypes = [u64p, ctypes.c_char_p, ctypes.c_uint64]
        lib.zn_keccak_finalize.argtypes = [u64p, ctypes.c_char_p, ctypes.c_uint64, u8p]
        lib.zn_blake3.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p]
        lib.zn_blake3_batch.argtypes = [ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint64, u8p]
        lib.zn_blake3_merge_batch.argtypes = [ctypes.c_char_p, ctypes.c_uint64, u8p]
        lib.zn_merkle_fold_batch.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, u64p, ctypes.c_uint64, ctypes.c_uint64, u8p,
        ]
        lib.zn_merkle_fold_batch_strided.argtypes = [
            ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.c_uint64, u64p, ctypes.c_uint64, ctypes.c_uint64, u8p,
        ]
        _lib = lib
        return _lib


def blake3_batch(messages: bytes, n: int, msg_len: int) -> bytes | None:
    """Hash n contiguous equal-length messages; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * (32 * n))()
    lib.zn_blake3_batch(messages, n, msg_len, out)
    return bytes(out)


def blake3_merge_batch(pairs: bytes, n: int) -> bytes | None:
    """n 64-byte digest pairs → n parent digests; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = (ctypes.c_uint8 * (32 * n))()
    lib.zn_blake3_merge_batch(pairs, n, out)
    return bytes(out)


def merkle_fold_batch(leaves: bytes, siblings: bytes, indices, depth: int) -> bytes | None:
    """Fold n Merkle paths to roots; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(leaves) // 32
    idx_arr = (ctypes.c_uint64 * n)(*indices)
    out = (ctypes.c_uint8 * (32 * n))()
    lib.zn_merkle_fold_batch(leaves, siblings, idx_arr, n, depth, out)
    return bytes(out)


def merkle_fold_batch_strided(
    leaves: bytes,
    sib_buffer,
    sib_offset: int,
    rec_stride: int,
    paths_per_rec: int,
    path_stride: int,
    indices,
    depth: int,
) -> bytes | None:
    """Fold n Merkle paths whose siblings live inside a strided record buffer
    (e.g. the raw proof byte stream) — no repacking copy.  ``indices`` is a
    uint64 numpy array; path p's siblings start at
    ``sib_buffer[sib_offset + (p//paths_per_rec)*rec_stride + (p%paths_per_rec)*path_stride]``.
    """
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np

    n = len(leaves) // 32
    idx_arr = np.ascontiguousarray(indices, dtype=np.uint64)
    buf = np.frombuffer(sib_buffer, np.uint8)
    base = buf.ctypes.data + sib_offset
    out = (ctypes.c_uint8 * (32 * n))()
    lib.zn_merkle_fold_batch_strided(
        leaves, ctypes.c_void_p(base), rec_stride, paths_per_rec, path_stride,
        idx_arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)), n, depth, out,
    )
    return bytes(out)
