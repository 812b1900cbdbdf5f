from .prover import CombSpec, SumcheckProof, prove_as_subprotocol
from .verifier import SubClaim, SumcheckError, interpolate_uni_poly, verify_as_subprotocol

__all__ = [
    "CombSpec",
    "SumcheckProof",
    "prove_as_subprotocol",
    "SubClaim",
    "SumcheckError",
    "interpolate_uni_poly",
    "verify_as_subprotocol",
]
