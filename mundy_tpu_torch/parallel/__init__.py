"""Multi-rank execution over torch.distributed.

Port of mundy_tpu/parallel/, one process per rank in place of the
reference's device mesh: `comm` holds the collectives (ppermute, psum,
pmax, all_gather), the backend rule and the rank launcher; `ring_rpy` the
ring-rotated dense RPY apply; `slab_local` the slab-local row resort;
`slab_rows` and `slab_segments` the z-slab spheres and rods engines;
`balanced_slab` the density-balanced z-slab decomposition (and its settling
demonstrator), on which `balanced_lcp` runs the LCP spheres pipeline and
`granular_shard` the granular DEM with migrating contact history;
`spectral_shard` the spectral-Ewald RPY mobility over the ranks,
`chromatin_shard` the whole-chain chromatin engine and `filaments_shard`
the whole-filament engine; `slab` the x-slab halo exchange and migration,
on which `sharded_step` runs the gather-halo (v1) and slab (v2) spheres
steps, and `slab_lcp` the volume-allocated z-slab LCP engine that
`balanced_lcp` supersedes. The reference's exports are the first six names
of __all__.
"""

from mundy_tpu_torch.parallel.balanced_lcp import make_balanced_lcp_step
from mundy_tpu_torch.parallel.balanced_slab import (
    BalancedEngine,
    balanced_bounds,
    make_balanced_settling_step,
    reference_settling_step,
    uniform_bounds,
)
from mundy_tpu_torch.parallel.comm import (
    Group,
    RankError,
    backend_plan,
    init_group,
    ring_perms,
    spawn_ranks,
)
from mundy_tpu_torch.parallel.chromatin_shard import ShardEngine, make_sharded_chromatin_step
from mundy_tpu_torch.parallel.filaments_shard import make_sharded_filaments_step
from mundy_tpu_torch.parallel.granular_shard import make_granular_slab_step
from mundy_tpu_torch.parallel.ring_rpy import (
    hilbert_shard_permutation,
    make_replicated_ring_apply,
    make_ring_rpy_apply,
)
from mundy_tpu_torch.parallel.sharded_step import (
    make_sharded_spheres_step,
    make_slab_spheres_step,
)
from mundy_tpu_torch.parallel.slab import ShardState, halo_exchange, migrate, slab_bounds
from mundy_tpu_torch.parallel.slab_lcp import make_slab_lcp_spheres_step
from mundy_tpu_torch.parallel.slab_local import local_resort_ok, slab_local_resort
from mundy_tpu_torch.parallel.slab_rows import SlabEngine, make_slab_rows_spheres_step
from mundy_tpu_torch.parallel.slab_segments import make_slab_rods_step
from mundy_tpu_torch.parallel.spectral_shard import make_se_local_apply, make_sharded_se_rpy_apply

__all__ = [
    "make_sharded_spheres_step",
    "make_slab_spheres_step",
    "ShardState",
    "halo_exchange",
    "migrate",
    "slab_bounds",
    "make_slab_lcp_spheres_step",
    "BalancedEngine",
    "Group",
    "RankError",
    "ShardEngine",
    "SlabEngine",
    "backend_plan",
    "balanced_bounds",
    "hilbert_shard_permutation",
    "init_group",
    "local_resort_ok",
    "make_balanced_lcp_step",
    "make_balanced_settling_step",
    "make_granular_slab_step",
    "make_se_local_apply",
    "make_replicated_ring_apply",
    "make_ring_rpy_apply",
    "make_sharded_chromatin_step",
    "make_sharded_filaments_step",
    "make_sharded_se_rpy_apply",
    "make_slab_rods_step",
    "make_slab_rows_spheres_step",
    "reference_settling_step",
    "ring_perms",
    "slab_local_resort",
    "spawn_ranks",
    "uniform_bounds",
]
