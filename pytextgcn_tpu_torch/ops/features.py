"""Structured node features.

Port of ``pytextgcn_tpu/ops/features.py``. The reference materializes an
N x N identity feature matrix (plus optional per-document "hierarchy"
columns) and pushes it through the first GCN layer; here that product is
structure: ``I @ W == W`` and the hierarchy block is a skinny dense matmul
over document rows only, so the identity never exists.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple, Union

import torch

from ..core.graph import TextGraph
from ..utils import resolve_device


@dataclasses.dataclass
class NodeFeatures:
    """Either explicit dense features ``x`` [N, D], or implicit identity
    features (+ optional hierarchy columns on document rows).

    ``node_ids`` restricts the implicit-identity form to a subgraph: row i
    is the feature row of *global* node ``node_ids[i]`` (padding: -1), so
    ``matmul`` becomes a row gather of the weight matrix. ``block``
    ``(lo, n_rows)`` restricts any form to rows ``[lo, lo + n_rows)``, rows
    past the last node zero (a halo rank's rows, :meth:`row_block`)."""

    n_vocab: int
    n_docs: int
    x: Optional[torch.Tensor] = None
    hierarchy: Optional[torch.Tensor] = None  # [n_docs, F]
    node_ids: Optional[torch.Tensor] = None  # [M] global ids, -1 = padding
    block: Optional[Tuple[int, int]] = None  # (first row, rows)

    @staticmethod
    def from_graph(g: TextGraph,
                   device: Optional[Union[str, torch.device]] = None) -> "NodeFeatures":
        device = resolve_device(device)
        put = lambda a: None if a is None else torch.as_tensor(a, dtype=torch.float32,
                                                               device=device)
        return NodeFeatures(
            n_vocab=g.n_vocab, n_docs=g.n_docs, x=put(g.x), hierarchy=put(g.hierarchy_feats)
        )

    def subgraph(self, node_ids: torch.Tensor) -> "NodeFeatures":
        """Features for the subgraph whose local row i is global node
        ``node_ids[i]``. Keeps the global ``in_dim``; explicit features are
        sliced, implicit ones deferred to a gather in :meth:`matmul`."""
        ids = torch.as_tensor(node_ids)
        if self.x is not None:
            return NodeFeatures(self.n_vocab, self.n_docs,
                                x=self.x[ids.clamp(min=0).to(self.x.device)])
        return NodeFeatures(self.n_vocab, self.n_docs, hierarchy=self.hierarchy,
                            node_ids=ids)

    def row_block(self, lo: int, n_rows: int) -> "NodeFeatures":
        """Rows ``[lo, lo + n_rows)`` of the features, rows past the last
        node zero: a halo rank's first-layer input. :meth:`matmul` slices
        the whole product, so its gradient is a slice too, not a scatter."""
        return dataclasses.replace(self, block=(lo, n_rows))

    @property
    def n_nodes(self) -> int:
        return self.n_vocab + self.n_docs

    @property
    def is_identity(self) -> bool:
        """Whether X is the whole N x N identity: :meth:`matmul` is ``w[:N]``."""
        return (self.x is None and self.hierarchy is None and self.node_ids is None
                and self.block is None)

    @property
    def in_dim(self) -> int:
        if self.x is not None:
            return int(self.x.shape[1])
        extra = 0 if self.hierarchy is None else int(self.hierarchy.shape[1])
        return self.n_nodes + extra

    def matmul(self, w: torch.Tensor) -> torch.Tensor:
        """``X @ w`` without materializing X. ``w``: [in_dim, H]."""
        if self.block is not None:
            lo, n_rows = self.block
            if self.x is not None:
                out = self.x[lo:lo + n_rows] @ w
            else:
                out = dataclasses.replace(self, block=None).matmul(w)[lo:lo + n_rows]
            return torch.nn.functional.pad(out, (0, 0, 0, n_rows - out.shape[0]))
        if self.x is not None:
            return self.x @ w
        n = self.n_nodes
        if self.node_ids is not None:
            node_ids = self.node_ids.to(w.device)
            ids = node_ids.clamp(min=0)
            out = w[ids]
            if self.hierarchy is not None:
                is_doc = (ids >= self.n_vocab) & (node_ids >= 0)
                hrows = self.hierarchy[(ids - self.n_vocab).clamp(0, self.n_docs - 1)]
                out = out + torch.where(is_doc[:, None], hrows @ w[n:], 0.0)
            return out
        out = w[:n]
        if self.hierarchy is not None:
            doc_part = self.hierarchy @ w[n:]
            out = torch.cat([out[: self.n_vocab], out[self.n_vocab:] + doc_part])
        return out
