"""Distributed layer (L3): mesh construction, column-block (TP-analog) and
row (DP-analog) sharding of A, and residual/gradient-consensus collectives
(psum / ppermute ring) under shard_map.  See SURVEY.md section 2.2/2.3 —
this subsystem replaces nothing in the reference (which is single-process,
single-GPU); on the GPU, XLA hands the collectives to NCCL.
"""

from convex_optimization_tpu.parallel import mesh
from convex_optimization_tpu.parallel.mesh import make_mesh, BLOCKS, ROWS

__all__ = ["mesh", "make_mesh", "BLOCKS", "ROWS"]
