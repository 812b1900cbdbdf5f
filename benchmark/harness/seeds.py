"""Streams of randomness by (seed, step): the same pair gives the same
inputs in every run, on both sides of a comparison."""

from __future__ import annotations

import hashlib

import numpy as np

M64 = (1 << 64) - 1
WARM = 1 << 40  # warm-up steps are WARM, WARM + 1, ...: never a window's step


def rng(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng([seed & M64, step & M64])


def seed64(seed: int, step: int) -> int:
    """A 63-bit seed for a device generator."""
    digest = hashlib.sha256(f"{seed}:{step}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
