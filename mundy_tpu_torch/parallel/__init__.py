"""Multi-rank execution over torch.distributed.

Port of mundy_tpu/parallel/, one process per rank in place of the
reference's device mesh: `comm` holds the collectives (ppermute, psum,
pmax, all_gather), the backend rule and the rank launcher; `ring_rpy` the
ring-rotated dense RPY apply; `slab_local` the slab-local row resort;
`slab_rows` and `slab_segments` the z-slab spheres and rods engines. The
reference's package exports (`slab`, `sharded_step`) and its other engines
wait (ROADMAP queue 1, item 8).
"""

from mundy_tpu_torch.parallel.comm import (
    Group,
    RankError,
    backend_plan,
    init_group,
    ring_perms,
    spawn_ranks,
)
from mundy_tpu_torch.parallel.ring_rpy import hilbert_shard_permutation, make_ring_rpy_apply
from mundy_tpu_torch.parallel.slab_local import local_resort_ok, slab_local_resort
from mundy_tpu_torch.parallel.slab_rows import SlabEngine, make_slab_rows_spheres_step
from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step

__all__ = [
    "Group",
    "RankError",
    "SlabEngine",
    "backend_plan",
    "hilbert_shard_permutation",
    "init_group",
    "local_resort_ok",
    "make_ring_rpy_apply",
    "make_slab_rods_step",
    "make_slab_rows_spheres_step",
    "ring_perms",
    "slab_local_resort",
    "spawn_ranks",
]
