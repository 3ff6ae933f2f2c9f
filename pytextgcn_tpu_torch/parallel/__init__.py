"""Graph-partitioned and tensor-parallel training on ``torch.distributed``
(port of ``pytextgcn_tpu/parallel/``): the process group and meshes
(:mod:`.multihost`), the all-gather edge partition (:mod:`.sharded`), the
halo exchange (:mod:`.halo`), the sharded hybrid (:mod:`.hybrid_sharded`),
the sharded masked head (:mod:`.restricted_sharded`) and tensor parallelism
for the EGCN embedding (:mod:`.tensor`)."""

from .halo import HaloAdj, build_halo_adj, build_halo_core, spmm_halo
from .hybrid_sharded import HybridShardedAdj, build_hybrid_sharded_adj, spmm_hybrid_sharded
from .multihost import global_mesh, host_local_mesh, init_distributed
from .restricted_sharded import (
    ReplicatedHead,
    RestrictedShardedAdj,
    build_restricted_sharded_adj,
    spmm_restricted_sharded,
)
from .sharded import (
    Mesh,
    ShardedAdj,
    build_sharded_adj,
    make_mesh,
    put_global,
    replicate_global,
    spmm_sharded,
)
from .tensor import apply_tp, apply_tp_state, tp_param_shardings

__all__ = [
    "HaloAdj",
    "build_halo_adj",
    "build_halo_core",
    "spmm_halo",
    "HybridShardedAdj",
    "build_hybrid_sharded_adj",
    "spmm_hybrid_sharded",
    "ReplicatedHead",
    "RestrictedShardedAdj",
    "build_restricted_sharded_adj",
    "spmm_restricted_sharded",
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
    "apply_tp",
    "apply_tp_state",
    "tp_param_shardings",
]
