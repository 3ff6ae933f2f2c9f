"""Graph-partitioned training on ``torch.distributed`` (port of
``pytextgcn_tpu/parallel/``): the process group and meshes
(:mod:`.multihost`), the all-gather edge partition (:mod:`.sharded`) and
the halo exchange (:mod:`.halo`). The sharded hybrid, the sharded masked
head and tensor parallelism are not ported yet (ROADMAP.md §1 item 4b)."""

from .halo import HaloAdj, build_halo_adj, build_halo_core, spmm_halo
from .multihost import global_mesh, host_local_mesh, init_distributed
from .sharded import (
    Mesh,
    ShardedAdj,
    build_sharded_adj,
    make_mesh,
    put_global,
    replicate_global,
    spmm_sharded,
)

__all__ = [
    "HaloAdj",
    "build_halo_adj",
    "build_halo_core",
    "spmm_halo",
    "Mesh",
    "ShardedAdj",
    "build_sharded_adj",
    "make_mesh",
    "put_global",
    "replicate_global",
    "spmm_sharded",
    "init_distributed",
    "global_mesh",
    "host_local_mesh",
]
