"""Sparse-dense matmul (neighborhood aggregation) dispatch.

``spmm(adj, x)`` computes ``A_hat @ x`` for the normalized adjacency:
``out[i] = self_w[i] * x[i] + sum_{e: dst[e]==i} w[e] * x[src[e]]``.
Port of ``pytextgcn_tpu/ops/spmm.py``. Three paths:

* hybrid plan: the dense-hot/sparse-cold decomposition (:mod:`.hybrid`);
* CSR plan: the CSR kernel (:mod:`.spmm_cuda`) through its autograd
  function, which runs the kernel on the transpose plan for the gradient;
* no plan: gather + ``index_add_`` (:func:`spmm_segment`), differentiated
  by autograd — the exact oracle, as ``spmm_segment`` is in the JAX package.
"""

from __future__ import annotations

import torch

from .adjacency import NormAdj
from .hybrid import HybridPlan, spmm_hybrid
from .spmm_cuda import spmm_plan


def spmm_segment(adj: NormAdj, x: torch.Tensor) -> torch.Tensor:
    """Gather / ``index_add_`` aggregation."""
    contrib = adj.w[:, None] * x[adj.src]
    agg = torch.zeros(adj.n_nodes, x.shape[1], dtype=contrib.dtype, device=x.device)
    agg = agg.index_add(0, adj.dst, contrib)
    return agg + adj.self_w[:, None] * x


def spmm(adj: NormAdj, x: torch.Tensor) -> torch.Tensor:
    if isinstance(adj.plan, HybridPlan):
        return spmm_hybrid(adj.plan, x) + adj.self_w[:, None] * x
    if adj.plan is not None:
        return spmm_plan(adj.plan, x) + adj.self_w[:, None] * x
    return spmm_segment(adj, x)
