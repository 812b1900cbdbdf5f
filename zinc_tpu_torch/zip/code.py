"""Linear codes for the Zip PCS: RAA (default) and the original Zip code.

``RaaCode`` mirrors zinc/src/zip/code_raa.rs: codeword =
accumulate(shuffle₂(accumulate(shuffle₁(repeat(row))))) with the two
permutation seeds squeezed from the transcript, plus the static width check
K_bits ≥ N_bits + num_vars_even + 2·log₂(repetition).

``ZipLinearCode`` mirrors zinc/src/zip/code.rs:77-215: codeword =
[A·row ‖ B·row] for two transcript-sampled sparse {0,1} matrices with d
non-zeros per row (columns sampled as a sorted unique set, then one encoding
bit per column, in sorted order).

Host encoders operate on exact Python ints (the reference's fixed widths are
guaranteed non-overflowing, so exact arithmetic is bit-identical); the device
encoder (zip/device.py) uses limb-plane cumulative sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import isqrt

import numpy as np

from ..fields.config import FieldConfig, Fp
from ..rng import permutation_from_seed


class LinearCodeSpec:
    def num_column_opening(self) -> int:
        raise NotImplementedError

    def repetition_factor(self) -> int:
        raise NotImplementedError

    def num_proximity_testing(self, log2_q: int, n: int, n_0: int) -> int:
        raise NotImplementedError


class DefaultLinearCodeSpec(LinearCodeSpec):
    """1000 column openings, rate 1/2, one proximity test
    (zinc/src/zip/code.rs:229-242)."""

    def num_column_opening(self) -> int:
        return 1000

    def repetition_factor(self) -> int:
        return 2

    def num_proximity_testing(self, log2_q: int, n: int, n_0: int) -> int:
        return 1


def _next_pow2(x: int) -> int:
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def _row_len_for(poly_size: int) -> int:
    num_vars = poly_size.bit_length() - 1
    return _next_pow2(isqrt(1 << num_vars))


@dataclass
class ZipTypes:
    """The N→L→K→M integer width ladder, in 64-bit words
    (zinc/src/traits/types.rs:202-217)."""

    n_words: int

    @property
    def l_words(self) -> int:
        return 2 * self.n_words

    @property
    def k_words(self) -> int:
        return 4 * self.n_words

    @property
    def m_words(self) -> int:
        return 8 * self.n_words


class RaaCode:
    """Repeat-accumulate-accumulate code (Blaze, eprint 2024/1609)."""

    def __init__(self, spec: LinearCodeSpec, poly_size: int, transcript, zt: ZipTypes):
        num_vars = poly_size.bit_length() - 1
        self.zt = zt
        self.row_len = _row_len_for(poly_size)
        self.repetition_factor = spec.repetition_factor()
        self._num_column_opening = spec.num_column_opening()
        log2_q = zt.n_words
        n_0 = min(20, (1 << num_vars) - 1)
        self._num_proximity_testing = spec.num_proximity_testing(log2_q, self.row_len, n_0)

        rep_log = _next_pow2(self.repetition_factor).bit_length() - 1
        num_vars_even = num_vars + (num_vars & 1)
        codeword_width_bits = 64 * zt.n_words + num_vars_even + 2 * rep_log
        # |codeword value| < 2^codeword_width_bits: limbs above this are pure
        # sign extension on the wire (used to narrow device downloads)
        self.codeword_width_bits = codeword_width_bits
        if 64 * zt.k_words < codeword_width_bits:
            raise ValueError(
                f"Cannot fit {codeword_width_bits}-bit codeword entries in "
                f"{64 * zt.k_words}-bit integers"
            )

        self.perm_1_seed = transcript.get_u64()
        self.perm_2_seed = transcript.get_u64()
        self._perm_cache: tuple[np.ndarray, np.ndarray] | None = None

    # -- geometry -----------------------------------------------------------

    def codeword_len(self) -> int:
        return self.row_len * self.repetition_factor

    def num_column_opening(self) -> int:
        return self._num_column_opening

    def num_proximity_testing(self) -> int:
        return self._num_proximity_testing

    def permutations(self) -> tuple[np.ndarray, np.ndarray]:
        if self._perm_cache is None:
            n = self.codeword_len()
            self._perm_cache = (
                permutation_from_seed(self.perm_1_seed, n),
                permutation_from_seed(self.perm_2_seed, n),
            )
        return self._perm_cache

    # -- encoders -----------------------------------------------------------

    def encode(self, row: list[int]) -> list[int]:
        """Integer encoding (exact arithmetic; widths guaranteed to fit)."""
        assert len(row) == self.row_len, "row length must match the code"
        p1, p2 = self.permutations()
        vec = row * self.repetition_factor
        vec = [vec[i] for i in p1]
        acc = 0
        out1 = []
        for v in vec:
            acc += v
            out1.append(acc)
        vec = [out1[i] for i in p2]
        acc = 0
        out2 = []
        for v in vec:
            acc += v
            out2.append(acc)
        return out2

    def encode_f(self, row: list[Fp], cfg: FieldConfig) -> list[Fp]:
        """Field encoding (verifier's evaluation-phase re-encode)."""
        assert len(row) == self.row_len
        p1, p2 = self.permutations()
        vec = row * self.repetition_factor
        vec = [vec[i] for i in p1]
        acc = cfg.zero()
        out1 = []
        for v in vec:
            acc = acc + v
            out1.append(acc)
        vec = [out1[i] for i in p2]
        acc = cfg.zero()
        out2 = []
        for v in vec:
            acc = acc + v
            out2.append(acc)
        return out2


class ZipLinearCode:
    """The original Zip code: codeword = [A·row ‖ B·row] with sparse ±{0,1}
    matrices sampled from the transcript."""

    def __init__(self, spec: LinearCodeSpec, poly_size: int, transcript, zt: ZipTypes):
        assert poly_size & (poly_size - 1) == 0
        num_vars = poly_size.bit_length() - 1
        n_0 = min(20, (1 << num_vars) - 1)
        assert (1 << num_vars) > n_0
        self.zt = zt
        self.row_len = _row_len_for(poly_size)
        self._codeword_len = self.row_len * spec.repetition_factor()
        self._num_column_opening = spec.num_column_opening()
        self._num_proximity_testing = spec.num_proximity_testing(zt.n_words, self.row_len, n_0)
        rows = self._codeword_len // 2
        density = self.row_len // 2
        # |A·row| ≤ density·max|row| < 2^(64n + log2(density) + 1)
        self.codeword_width_bits = (
            64 * zt.n_words + max(density, 1).bit_length() + 1
        )
        self.a = _sample_sparse_matrix(rows, self.row_len, density, transcript)
        self.b = _sample_sparse_matrix(rows, self.row_len, density, transcript)

    def codeword_len(self) -> int:
        return self._codeword_len

    def num_column_opening(self) -> int:
        return self._num_column_opening

    def num_proximity_testing(self) -> int:
        return self._num_proximity_testing

    def encode(self, row: list[int]) -> list[int]:
        assert len(row) == self.row_len
        return _sparse_mat_vec(self.a, row) + _sparse_mat_vec(self.b, row)

    def encode_f(self, row: list[Fp], cfg: FieldConfig) -> list[Fp]:
        assert len(row) == self.row_len
        za = _sparse_mat_vec_f(self.a, row, cfg)
        zb = _sparse_mat_vec_f(self.b, row, cfg)
        return za + zb


def _sample_sparse_matrix(rows: int, cols: int, density: int, transcript):
    """Per row: a sorted set of `density` unique columns, then one {0,1}
    encoding element per column (code.rs:280-295)."""
    cells = []
    for _ in range(rows):
        columns: set = set()
        transcript.sample_unique_columns(0, cols, columns, density)
        cells.append([(col, transcript.get_encoding_element()) for col in sorted(columns)])
    return cells


def _sparse_mat_vec(cells, vector: list[int]) -> list[int]:
    return [sum(coeff * vector[col] for col, coeff in row) for row in cells]


def _sparse_mat_vec_f(cells, vector: list[Fp], cfg: FieldConfig) -> list[Fp]:
    out = []
    for row in cells:
        acc = cfg.zero()
        for col, coeff in row:
            if coeff:
                acc = acc + vector[col]
        out.append(acc)
    return out
