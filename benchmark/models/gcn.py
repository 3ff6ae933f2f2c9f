"""Model kind ``gcn``: the reference system's GCN (BeFranke/PyTextGCN
``textgcn/lib/models.py:6-26``): ``n_gcn`` graph convolutions ``A_hat (X W) +
b`` on identity features (so the first is ``A_hat W + b``), no activation
between them, inverted dropout after each but the last."""

from __future__ import annotations

import math
from typing import List, Tuple


def widths(model: dict, first: int, n_classes: int) -> List[int]:
    """The stack's widths, input first."""
    return [first] + [int(model["n_hidden"])] * (int(model["n_gcn"]) - 1) + [int(n_classes)]


def stack_leaves(dims: List[int]) -> List[Tuple[str, tuple, float]]:
    """Each convolution's weight, glorot ``U(+-sqrt(6 / (fan_in + fan_out)))``,
    and bias, zeros (torch-geometric 1.6.3's GCNConv)."""
    out = []
    for i, (a, b) in enumerate(zip(dims[:-1], dims[1:])):
        out += [(f"layers.{i}.w", (a, b), math.sqrt(6.0 / (a + b))), (f"layers.{i}.b", (b,), 0.0)]
    return out


def leaves(model: dict, n_nodes: int, n_classes: int) -> List[Tuple[str, tuple, float]]:
    """``(leaf name, shape, uniform half-range)``; a range of 0 is zeros."""
    return stack_leaves(widths(model, n_nodes, n_classes))


def spmm_widths(model: dict, n_classes: int) -> List[int]:
    """The widths of one forward pass's ``A_hat`` applications."""
    return widths(model, 0, n_classes)[1:]


def flops_per_epoch(model: dict, n_nodes: int, n_edges: int, n_classes: int) -> int:
    """Operations of a train step and a forward evaluation, counted from the
    shapes. With ``nnz = E + N`` (self-loops included): each ``A_hat``
    application at width ``w`` is ``2 nnz w``, three times (forward, its
    gradient, the evaluation); each dense ``[N, a] x [a, b]`` product after the
    first layer is ``2 N a b``, four times (forward, two gradients, the
    evaluation). For 2 layers: ``6 nnz (H + C) + 8 N H C``. Elementwise work,
    the loss and the optimizer are not counted."""
    n, nnz = int(n_nodes), int(n_edges) + int(n_nodes)
    dims = widths(model, n, n_classes)
    return sum(3 * 2 * nnz * w for w in dims[1:]) + sum(
        4 * 2 * n * a * b for a, b in zip(dims[1:-1], dims[2:]))


def forward(model: dict, p: dict, spmm, mm, drop):
    """The logits from parameters ``p``; ``spmm(x)`` is ``A_hat @ x``, ``mm``
    the dense product, ``drop`` the dropout (the identity when evaluating)."""
    n = int(model["n_gcn"])
    h = spmm(p["layers.0.w"]) + p["layers.0.b"]
    for i in range(1, n):
        h = spmm(mm(drop(h), p[f"layers.{i}.w"])) + p[f"layers.{i}.b"]
    return h
