"""End-to-end example: prove and verify the R1CS for x³ + x + 5 = y.

The port of ``zinc_tpu/examples/simple_r1cs.py`` (the reference's
``examples/simple_r1cs.rs``): draw the verifier-random field from the public
input, prove with ``ZincProver``, verify with ``ZincVerifier`` on an
independent transcript.  On the card by default; on the CPU:

    python -m zinc_tpu_torch.examples.simple_r1cs cpu
"""

from __future__ import annotations

import sys

from ..ccs import vitalik_fixture
from ..prime import draw_random_field
from ..transcript import KeccakTranscript
from ..zinc import ZincProver, ZincVerifier
from ..zip.code import DefaultLinearCodeSpec, ZipTypes

INT_LIMBS = 1
FIELD_LIMBS = 4


def run_example(input_value: int = 3, verbose: bool = True, device="cuda"):
    zt = ZipTypes(INT_LIMBS)
    prover = ZincProver(zt, DefaultLinearCodeSpec(), device=device)

    ccs, statement, witness = vitalik_fixture(input_value)

    prover_transcript = KeccakTranscript()
    field_config = draw_random_field(
        statement.public_input, prover_transcript, zt.n_words, FIELD_LIMBS
    )
    if verbose:
        print(f"random field q = {field_config.q} ({field_config.q.bit_length()} bits)")

    proof = prover.prove(statement, witness, prover_transcript, ccs, field_config)
    if verbose:
        print(f"proof: {len(proof.spartan_proof.linearization_sumcheck)}+"
              f"{len(proof.spartan_proof.second_sumcheck)} sumcheck rounds, "
              f"{len(proof.zip_proof.pcs_proof)} PCS bytes")

    verifier = ZincVerifier(zt, DefaultLinearCodeSpec(), device=device)
    verifier.verify(statement, proof, KeccakTranscript(), ccs, field_config)
    if verbose:
        print("verification: ACCEPT")
    return proof


if __name__ == "__main__":
    run_example(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
