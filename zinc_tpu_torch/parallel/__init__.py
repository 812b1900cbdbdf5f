"""The sharded prover: a mesh of torch devices, in one process or over
several.

The port of ``zinc_tpu/parallel/``.  The sumcheck's hypercube axis is
block-sharded over the mesh (``sumcheck.py``), and the Zip codeword matrix
is row-sharded, or rows × columns on a 2-D mesh (``zip.py``); proofs are
byte-identical to one device's.  ``init_distributed`` and
``hierarchical_mesh`` give a ("host", "chip") mesh whose rows are processes
of ``torch.distributed`` (``mesh.py``).  Importing it loads no CUDA code
and starts no process group.
"""

from .mesh import (
    Mesh,
    ProcessGroup,
    fetch_global,
    hierarchical_mesh,
    init_distributed,
    local_mesh,
    local_mesh_2d,
    shard_on_axis,
)
from .sumcheck import ShardedSumcheckExecutor, prove_sharded
from .zip import commit_device_sharded, commit_device_sharded_2d

__all__ = [
    "Mesh",
    "ProcessGroup",
    "init_distributed",
    "hierarchical_mesh",
    "fetch_global",
    "local_mesh",
    "local_mesh_2d",
    "shard_on_axis",
    "ShardedSumcheckExecutor",
    "prove_sharded",
    "commit_device_sharded",
    "commit_device_sharded_2d",
]
