"""Field configuration: the random prime field Z_q and its Montgomery constants.

Mirrors the semantics of the reference's ``FieldConfig<N>``
(zinc/src/field/config.rs:29-187): a field is described by its
modulus q together with

    R   = 2^(64*n64) mod q          (Montgomery radix for n64 64-bit words)
    R2  = R^2 mod q
    inv = -q^{-1} mod 2^64

The *word count* ``n64`` is protocol-visible: field elements are absorbed into
the Fiat-Shamir transcript in Montgomery form as big-endian ``8*n64``-byte
strings (zinc/src/field.rs:360-379), so R is part of the wire
format, not an implementation detail.

Host-side field elements are plain Python ints holding the Montgomery residue
(`value`), wrapped in the light `Fp` class below.  The device representation
(uint32 arrays of 16-bit limbs, same Montgomery residue) lives in
fields/limbs.py / fields/montgomery.py; both representations are
interchangeable bit-for-bit.
"""

from __future__ import annotations

from functools import cached_property


class FieldConfig:
    """Modulus + Montgomery constants for Z_q with n64 64-bit words."""

    __slots__ = ("q", "n64", "r", "r2", "r_inv", "inv64", "has_spare_bit", "__dict__")

    def __init__(self, modulus: int, n64: int):
        if modulus <= 0 or modulus % 2 == 0:
            raise ValueError("modulus must be a positive odd integer")
        if modulus.bit_length() > 64 * n64:
            raise ValueError(f"modulus needs {modulus.bit_length()} bits > 64*{n64}")
        self.q = modulus
        self.n64 = n64
        radix = 1 << (64 * n64)
        self.r = radix % modulus
        self.r2 = (self.r * self.r) % modulus
        self.r_inv = pow(self.r, -1, modulus)
        self.inv64 = (-pow(modulus, -1, 1 << 64)) % (1 << 64)
        self.has_spare_bit = (modulus >> (64 * n64 - 1)) & 1 == 0

    # -- limb views ---------------------------------------------------------

    @property
    def n16(self) -> int:
        """Number of 16-bit limbs in the device representation."""
        return 4 * self.n64

    @cached_property
    def inv16(self) -> int:
        """-q^{-1} mod 2^16 — Montgomery constant for 16-bit-limb CIOS."""
        return (-pow(self.q, -1, 1 << 16)) % (1 << 16)

    @cached_property
    def nbytes(self) -> int:
        return 8 * self.n64

    # -- scalar Montgomery arithmetic (host reference path) -----------------

    def to_mont(self, v: int) -> int:
        """Map an integer (any sign / size) into Montgomery form.

        Matches the reference's ``map_to_field`` semantics for signed values
        (zinc/src/conversion.rs:9-100): reduce |v| mod q, then
        negate in the field if v < 0 — which is exactly Python's ``v % q``.
        """
        return ((v % self.q) * self.r) % self.q

    def from_mont(self, m: int) -> int:
        return (m * self.r_inv) % self.q

    def mont_mul(self, a: int, b: int) -> int:
        return (a * b * self.r_inv) % self.q

    def add(self, a: int, b: int) -> int:
        s = a + b
        return s - self.q if s >= self.q else s

    def sub(self, a: int, b: int) -> int:
        d = a - b
        return d + self.q if d < 0 else d

    def neg(self, a: int) -> int:
        return 0 if a == 0 else self.q - a

    def inv_mont(self, a: int) -> int:
        """Inverse in Montgomery form: inv(a·R)·R = a^{-1}·R."""
        if a == 0:
            raise ZeroDivisionError("field inverse of zero")
        return (pow(a, -1, self.q) * self.r) % self.q

    def value_bytes_be(self, mont_value: int) -> bytes:
        """Serialized (Montgomery-form) representation — the wire format."""
        return mont_value.to_bytes(self.nbytes, "big")

    def value_bytes_le(self, mont_value: int) -> bytes:
        return mont_value.to_bytes(self.nbytes, "little")

    def modulus_bytes_be(self) -> bytes:
        return self.q.to_bytes(self.nbytes, "big")

    # -- equality / misc ----------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, FieldConfig) and self.q == other.q

    def __hash__(self) -> int:
        return hash(self.q)

    def __repr__(self) -> str:
        return f"FieldConfig(q={self.q}, n64={self.n64})"

    # -- element constructors ----------------------------------------------

    def fp(self, v: int) -> "Fp":
        return Fp(self.to_mont(v), self)

    def fp_from_mont(self, m: int) -> "Fp":
        return Fp(m % self.q, self)

    def zero(self) -> "Fp":
        return Fp(0, self)

    def one(self) -> "Fp":
        return Fp(self.r, self)


class Fp:
    """A host-side field element: Montgomery residue + config.

    The canonical scalar type of the verifier and of all host protocol logic.
    Device kernels operate on batched limb arrays holding the same residues.
    """

    __slots__ = ("m", "cfg")

    def __init__(self, mont_value: int, cfg: FieldConfig):
        self.m = mont_value
        self.cfg = cfg

    # value access
    def to_int(self) -> int:
        return self.cfg.from_mont(self.m)

    def is_zero(self) -> bool:
        return self.m == 0

    # arithmetic
    def __add__(self, o: "Fp") -> "Fp":
        return Fp(self.cfg.add(self.m, o.m), self.cfg)

    def __sub__(self, o: "Fp") -> "Fp":
        return Fp(self.cfg.sub(self.m, o.m), self.cfg)

    def __mul__(self, o: "Fp") -> "Fp":
        return Fp(self.cfg.mont_mul(self.m, o.m), self.cfg)

    def __neg__(self) -> "Fp":
        return Fp(self.cfg.neg(self.m), self.cfg)

    def __truediv__(self, o: "Fp") -> "Fp":
        return self * o.inverse()

    def inverse(self) -> "Fp":
        return Fp(self.cfg.inv_mont(self.to_int()), self.cfg)

    def __pow__(self, e: int) -> "Fp":
        return Fp((pow(self.to_int(), e, self.cfg.q) * self.cfg.r) % self.cfg.q, self.cfg)

    def __eq__(self, o) -> bool:
        return isinstance(o, Fp) and self.m == o.m and self.cfg.q == o.cfg.q

    def __hash__(self) -> int:
        return hash((self.m, self.cfg.q))

    def __repr__(self) -> str:
        return f"Fp({self.to_int()} mod {self.cfg.q})"
