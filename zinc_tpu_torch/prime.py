"""Random-prime derivation: the `init()` step of the protocol.

``get_prime`` mirrors zinc/src/prime_gen.rs:15-28: draw
``8*n64`` transcript bytes, absorb them back, interpret them **big-endian**,
make the candidate odd by subtracting one if even, and accept on a
base-2 Miller-Rabin pass (crypto-primes ``MillerRabin::test_base_two``,
zinc/src/field/uint.rs:66-76).

``draw_random_field`` mirrors zinc/src/zinc/utils.rs:161-171:
absorb each public-input integer as its little-endian two's-complement words,
then run ``get_prime`` and build the field config.
"""

from __future__ import annotations

from .fields.config import FieldConfig
from .timing import timed
from .transcript import KeccakTranscript


def miller_rabin_base2(n: int) -> bool:
    """Single Miller-Rabin round with base 2 (matches crypto-primes test_base_two)."""
    if n < 2 or n % 2 == 0:
        return n == 2
    if n == 2 or n == 3:
        return True
    d = n - 1
    s = 0
    while d % 2 == 0:
        d //= 2
        s += 1
    x = pow(2, d, n)
    if x == 1 or x == n - 1:
        return True
    for _ in range(s - 1):
        x = (x * x) % n
        if x == n - 1:
            return True
    return False


def get_prime(transcript: KeccakTranscript, n64: int) -> int:
    """Rejection-sample a probable prime of up to 64*n64 bits from the transcript."""
    while True:
        nbytes = 8 * n64
        chunk = transcript.get_random_bytes(nbytes)
        transcript.absorb(chunk)
        candidate = int.from_bytes(chunk, "big")
        if candidate % 2 == 0:
            candidate -= 1
        if candidate > 0 and miller_rabin_base2(candidate):
            return candidate


def draw_random_field(
    public_inputs: list[int],
    transcript: KeccakTranscript,
    int_nwords: int,
    field_n64: int,
) -> FieldConfig:
    """Derive the verifier-random field Z_q from the public input.

    ``public_inputs`` are signed integers of width ``int_nwords`` 64-bit words;
    they are absorbed as little-endian two's-complement byte strings
    (``cast_slice(input.as_words())`` in the reference).
    """
    with timed("draw_field"):
        width = 1 << (64 * int_nwords)
        for v in public_inputs:
            transcript.absorb((v % width).to_bytes(8 * int_nwords, "little"))
        q = get_prime(transcript, field_n64)
        return FieldConfig(q, field_n64)
