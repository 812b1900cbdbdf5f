"""The sharded prover: a mesh of torch devices in one process.

The port of ``zinc_tpu/parallel/``.  The sumcheck's hypercube axis is
block-sharded over the mesh (``sumcheck.py``), and the Zip codeword matrix
is row-sharded, or rows × columns on a 2-D mesh (``zip.py``); proofs are
byte-identical to one device's.  Importing it loads no CUDA code.  The
reference's multi-process meshes (``init_distributed``,
``hierarchical_mesh``) are not ported.
"""

from .mesh import Mesh, fetch_global, local_mesh, local_mesh_2d, shard_on_axis
from .sumcheck import ShardedSumcheckExecutor, prove_sharded
from .zip import commit_device_sharded, commit_device_sharded_2d

__all__ = [
    "Mesh",
    "fetch_global",
    "local_mesh",
    "local_mesh_2d",
    "shard_on_axis",
    "ShardedSumcheckExecutor",
    "prove_sharded",
    "commit_device_sharded",
    "commit_device_sharded_2d",
]
