"""Multi-device parallelism: sharded signature verification + quorum counts.

Data parallelism over the signature batch, split across a mesh of devices
driven by one process (parallel/mesh.py), with the quorum-certificate
reduction as a sum over the mesh (`psum`) — the port of the JAX package's
``parallel/``.
"""

from .mesh import Mesh  # noqa: F401
from .sharded_verify import make_comb_quorum_step, make_quorum_step  # noqa: F401
