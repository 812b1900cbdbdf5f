"""zinc-tpu-torch: the Zinc SNARK prover and verifier in PyTorch + CUDA.

The port of ``zinc_tpu`` (JAX/Pallas on a TPU) to PyTorch on an NVIDIA H100.
The hot paths run as torch ops and hand-written CUDA kernels for sm_90a
(``csrc/``); protocol logic and Fiat-Shamir stay on the host, in the
package's own copies of the JAX package's framework-free modules
(``transcript.py``, ``spartan.py``, ``ccs/``, ``zip/code.py``, …; the port
imports nothing of ``zinc_tpu``).  The entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``.

Importing the package compiles and loads nothing: the CUDA kernels are built
at their first call on a CUDA tensor.
"""

from .ccs import CCS, CSError, Statement, Witness, dummy_ccs_of_size
from .fields.config import FieldConfig, Fp
from .prime import draw_random_field
from .transcript import KeccakTranscript
from .zip.code import DefaultLinearCodeSpec, LinearCodeSpec, RaaCode, ZipLinearCode, ZipTypes
from .serialize import deserialize_proof, serialize_proof
from .zinc import ZincError, ZincProof, ZincProver, ZincVerifier

__version__ = "0.1.0"

__all__ = [
    "CCS",
    "CSError",
    "Statement",
    "Witness",
    "dummy_ccs_of_size",
    "FieldConfig",
    "Fp",
    "draw_random_field",
    "KeccakTranscript",
    "DefaultLinearCodeSpec",
    "LinearCodeSpec",
    "RaaCode",
    "ZipLinearCode",
    "ZipTypes",
    "serialize_proof",
    "deserialize_proof",
    "ZincError",
    "ZincProof",
    "ZincProver",
    "ZincVerifier",
]
