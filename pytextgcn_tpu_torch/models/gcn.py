"""GCN and EGCN models.

Port of ``pytextgcn_tpu/models/gcn.py`` (the reference's
textgcn/lib/models.py:6-52): an N-layer GCNConv stack with dropout between
layers and — parity-critically — **no inter-layer activation** (the
reference comments the ReLU out; switchable via ``activation``).

Each layer is ``A_hat @ (X W) + b`` with ``A_hat`` precomputed
(ops/adjacency.py); for identity features ``X W == W``, so layer 1 is a
single SpMM over the weight matrix itself. Weights keep the JAX layout,
``w`` is ``[in, out]``, so parameters move between the two packages as
they are (:func:`load_jax_params`, :func:`export_params`).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import embedding
from ..ops.adjacency import NormAdj
from ..ops.features import NodeFeatures
from ..ops.spmm import row_block, spmm
from .layers import Dense, dropout, glorot


class GraphConv(nn.Module):
    """One GCNConv's parameters: glorot ``w`` [in, out], zero ``b`` (PyG
    1.6.3 init)."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.w = nn.Parameter(glorot((in_dim, out_dim), generator))
        self.b = nn.Parameter(torch.zeros(out_dim))


class GCN(nn.Module):
    """2-layer (by default) graph convolutional network.

    Matches reference ``GCN(in_channels, out_channels, n_gcn=2,
    n_hidden_gcn=64, dropout=0.5)``. Parameters are drawn on the CPU from
    ``generator`` (torch's default generator when None), so one seed gives
    the same model on every device; move it with ``.to(device)``.
    """

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        n_gcn: int = 2,
        n_hidden_gcn: int = 64,
        dropout: float = 0.5,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        if n_gcn < 2:
            raise ValueError(f"n_gcn must be >= 2, got {n_gcn}")
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.n_gcn = n_gcn
        self.n_hidden = n_hidden_gcn
        self.dropout = dropout
        self.activation = activation  # None == reference parity (no act)
        dims = [in_dim] + [n_hidden_gcn] * (n_gcn - 1) + [out_dim]
        self.layers = nn.ModuleList(
            GraphConv(d_in, d_out, generator) for d_in, d_out in zip(dims[:-1], dims[1:])
        )

    def jax_tree(self) -> Dict[str, Any]:
        """The JAX package's parameter tree of this model, with each leaf a
        ``(parameter, stored_transposed)`` pair."""
        return {"layers": [{"w": (layer.w, False), "b": (layer.b, False)}
                           for layer in self.layers]}

    def forward(
        self,
        adj: NormAdj,
        feats: NodeFeatures,
        *,
        train: bool = False,
        generator: Optional[torch.Generator] = None,
        adj_out=None,
    ) -> torch.Tensor:
        """Logits [N, out_dim]. ``generator`` draws the dropout masks when
        ``train``. ``adj_out``: an output-row-restricted operator
        (ops/restricted.py) for the final layer's aggregation, the masked
        head's training path: the logits are then ``[M, out_dim]`` for its
        M rows. Evaluation passes None. Under a halo operator ``feats`` and
        the logits are this rank's rows (``ops/spmm.py::row_block``)."""
        rows = row_block(adj)
        first, *rest = self.layers
        h = spmm(adj, feats.matmul(first.w)) + first.b
        for i, layer in enumerate(rest):
            if self.activation is not None:
                h = self.activation(h)
            h = dropout(h, self.dropout, train, generator, rows)
            a = adj_out if (adj_out is not None and i == len(rest) - 1) else adj
            h = spmm(a, h @ layer.w) + layer.b
        return h


class EGCN(GCN):
    """Embedding-GCN: a dense embedding layer (Linear + SELU + dropout) in
    front of the GCN stack (reference models.py:28-52). With identity
    features the embedding ``X @ W_emb + b`` collapses to ``W_emb + b``: no
    N x N product.

    Reference quirk kept: its loop condition over ``layers[1:]`` is always
    true (models.py:46-50), so dropout follows every GCN layer, the logits
    included."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        embedding_dim: int = 2000,
        n_gcn: int = 2,
        n_hidden_gcn: int = 64,
        dropout: float = 0.5,
        activation: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
        generator: Optional[torch.Generator] = None,
    ):
        # the GCN stack starts at the embedding width
        super().__init__(embedding_dim, out_dim, n_gcn, n_hidden_gcn, dropout, activation,
                         generator)
        self.in_dim = in_dim
        self.embedding_dim = embedding_dim
        self.embed = Dense(in_dim, embedding_dim, generator)
        self.tp = None  # the tensor-parallel layout (parallel/tensor.py::apply_tp)

    def jax_tree(self) -> Dict[str, Any]:
        return {"embed": {"w": (self.embed.w, False), "b": (self.embed.b, False)},
                **super().jax_tree()}

    def forward(self, adj: NormAdj, feats: NodeFeatures, *, train: bool = False,
                generator: Optional[torch.Generator] = None, adj_out=None) -> torch.Tensor:
        """As :meth:`GCN.forward`. Under ``adj_out`` the dropout on the logits
        draws an ``[M, out_dim]`` mask, so a masked-head run is statistically
        equal to the full-output one, not equal step for step. Under a
        tensor-parallel layout (``self.tp``) the embedding is this rank's
        columns of every row (``feats`` whole) and the first contraction is
        summed over the ranks; a row-sharded operator then takes the rank's
        rows of the sum. On one card with identity features the embedding's
        bias, SELU and dropout run as one pass each way
        (``ops/embedding.py``), bit for bit with the composition here."""
        rows, tp = row_block(adj), self.tp
        w, b = self.embed.w, self.embed.b
        if embedding.takes(w, feats, tp, rows):
            h = embedding.selu_dropout(w, b, self.dropout, train, generator)
        else:
            h = torch.selu(feats.matmul(w) + b)
            if tp is None:
                h = dropout(h, self.dropout, train, generator, rows)
            else:
                h = dropout(h, self.dropout, train, generator, cols=tp.cols)
        for i, layer in enumerate(self.layers):
            a = adj_out if (adj_out is not None and i == len(self.layers) - 1) else adj
            xw = h @ layer.w
            if i == 0 and tp is not None:
                xw = tp.all_reduce(xw) if rows is None else tp.reduce_rows(xw, adj.rows_per)
            h = spmm(a, xw) + layer.b
            if self.activation is not None:
                h = self.activation(h)
            h = dropout(h, self.dropout, train, generator, rows)
        return h


def _pairs(tree, given, path: str = "params") -> Iterator[Tuple[str, Any, Any]]:
    """(path, model leaf, given leaf) for every leaf, checking that
    ``given`` has the model tree's keys and list lengths."""
    if isinstance(tree, dict):
        if not isinstance(given, dict) or set(given) != set(tree):
            keys = sorted(given) if isinstance(given, dict) else type(given).__name__
            raise ValueError(f"{path}: keys {keys} given, model has {sorted(tree)}")
        for k in sorted(tree):
            yield from _pairs(tree[k], given[k], f"{path}/{k}")
    elif isinstance(tree, list):
        if not isinstance(given, (list, tuple)) or len(given) != len(tree):
            n = len(given) if isinstance(given, (list, tuple)) else type(given).__name__
            raise ValueError(f"{path}: {n} entries given, model has {len(tree)}")
        for i, (t, g) in enumerate(zip(tree, given)):
            yield from _pairs(t, g, f"{path}/{i}")
    else:
        yield path, tree, given


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v) for v in tree]
    return fn(tree)


def load_jax_params(model: nn.Module, params: Dict[str, Any]) -> nn.Module:
    """Copy a JAX parameter tree, given as numpy arrays, into ``model`` (a
    GCN ``{"layers": [{"w": [in, out], "b": [out]}, ...]}``, an EGCN with
    ``"embed"`` besides, or a JumpingKnowledgeNetwork). Keys, list lengths
    and shapes must match the model's."""
    with torch.no_grad():
        for path, (dst, transposed), src in _pairs(model.jax_tree(), params):
            src = torch.tensor(np.asarray(src, np.float32))
            if transposed:
                src = src.t()
            if src.shape != dst.shape:
                shape = tuple(src.t().shape if transposed else src.shape)
                want = tuple(dst.t().shape if transposed else dst.shape)
                raise ValueError(f"{path}: shape {shape} != {want}")
            dst.copy_(src)
    return model


def export_params(model: nn.Module) -> Dict[str, Any]:
    """The model's parameters as the JAX package's numpy parameter tree
    (copies: later training does not change them)."""
    def leaf(pair):
        p, transposed = pair
        a = p.detach().cpu()
        return (a.t() if transposed else a).numpy().copy()

    return _map_tree(leaf, model.jax_tree())
