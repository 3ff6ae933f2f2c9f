"""Sparse-dense matmul (neighborhood aggregation) dispatch.

``spmm(adj, x)`` computes ``A_hat @ x`` for the normalized adjacency:
``out[i] = self_w[i] * x[i] + sum_{e: dst[e]==i} w[e] * x[src[e]]``.
Port of ``pytextgcn_tpu/ops/spmm.py``. Three paths, the
output-row-restricted operator of the masked head
(:mod:`.restricted`, ``[M, H]`` out), and the operators partitioned over
ranks (:mod:`..parallel`: ``ShardedAdj``, replicated ``[N, H]`` in and out;
``HaloAdj``, ``HybridShardedAdj`` and ``RestrictedShardedAdj``, this rank's
``[rows_per, H]`` rows in and out; ``ReplicatedHead``, the sharded masked
head on replicated activations):

* hybrid plan: the dense-hot/sparse-cold decomposition (:mod:`.hybrid`);
* CSR plan: the CSR kernel (:mod:`.spmm_cuda`) through its autograd
  function, which runs the kernel on the transpose plan for the gradient;
* no plan: gather + ``index_add_`` (:func:`spmm_segment`), differentiated
  by autograd — the exact oracle, as ``spmm_segment`` is in the JAX package.
"""

from __future__ import annotations

import torch

from .adjacency import NormAdj
from .hybrid import HybridPlan, segment_sum, spmm_hybrid
from .restricted import RestrictedAdj, spmm_restricted
from .spmm_cuda import spmm_plan


def spmm_segment(adj: NormAdj, x: torch.Tensor) -> torch.Tensor:
    """Gather / ``index_add_`` aggregation."""
    return segment_sum(adj.src, adj.dst, adj.w, x, adj.n_nodes) + adj.self_w[:, None] * x


def row_block(adj):
    """``(N, first global row)`` of this rank's rows for an operator whose
    activations are row-sharded (the halo, the sharded hybrid and the
    sharded masked head), else None: dropout then draws the rank's rows of
    the full ``[N, H]`` mask (``models/layers.py``)."""
    return getattr(adj, "row_block", None)


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    from ..parallel import (HaloAdj, HybridShardedAdj,  # parallel imports ops
                            RestrictedShardedAdj, ShardedAdj, spmm_halo,
                            spmm_hybrid_sharded, spmm_restricted_sharded, spmm_sharded)
    from ..parallel.restricted_sharded import ReplicatedHead, spmm_replicated_head

    if isinstance(adj, HaloAdj):
        return spmm_halo(adj, x)
    if isinstance(adj, HybridShardedAdj):
        return spmm_hybrid_sharded(adj, x)
    if isinstance(adj, RestrictedShardedAdj):
        return spmm_restricted_sharded(adj, x)
    if isinstance(adj, ReplicatedHead):
        return spmm_replicated_head(adj, x)
    if isinstance(adj, ShardedAdj):
        return spmm_sharded(adj, x)
    if isinstance(adj, RestrictedAdj):
        return spmm_restricted(adj, x)
    if isinstance(adj.plan, HybridPlan):
        return spmm_hybrid(adj.plan, x) + adj.self_w[:, None] * x
    if adj.plan is not None:
        return spmm_plan(adj.plan, x) + adj.self_w[:, None] * x
    return spmm_segment(adj, x)
