"""Sparse-dense matmul (neighborhood aggregation).

``spmm(adj, x)`` computes ``A_hat @ x`` for the normalized adjacency:
``out[i] = self_w[i] * x[i] + sum_{e: dst[e]==i} w[e] * x[src[e]]``.
Port of ``pytextgcn_tpu/ops/spmm.py``. Each operator applies itself
(``adj.apply(x)``): ``NormAdj`` on its hybrid or CSR kernel plan or the
gather + ``index_add_`` path (:func:`spmm_segment`, differentiated by
autograd: the exact oracle), the masked head's ``RestrictedAdj``
(``[M, H]`` out) and the operators partitioned over ranks (parallel/).
"""

from __future__ import annotations

import torch

from .adjacency import NormAdj
from .hybrid import segment_sum


def spmm_segment(adj: NormAdj, x: torch.Tensor) -> torch.Tensor:
    """Gather / ``index_add_`` aggregation, whatever plan ``adj`` holds."""
    return segment_sum(adj.src, adj.dst, adj.w, x, adj.n_nodes) + adj.self_w[:, None] * x


def row_block(adj):
    """``(N, first global row)`` of this rank's rows where the operator's
    activations are row-sharded (``parallel/sharded.py::RowSharded``), else
    None: dropout then draws the rank's rows of the full ``[N, H]`` mask."""
    return adj.row_block


def spmm(adj, x: torch.Tensor) -> torch.Tensor:
    return adj.apply(x)
