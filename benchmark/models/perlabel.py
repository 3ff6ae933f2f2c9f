"""The per-label ensemble (BeFranke/PyTextGCN ``perlabel_amazon.py``): one
``gcn`` member (``benchmark/models/gcn.py``) per parent class, each over its
parent's child classes. Its initial parameters and dropout seeds, made by the
benchmark from ``--seed``, and its arithmetic: the widths of an epoch's
batched ``A_hat`` applications and its operations an epoch.

Everything is counted from the configuration's shapes, the graph's sizes and
the members' class counts (the corpus's hierarchy, drawn from the seed), never
from what the program built. The batched step applies ``A_hat`` once to the
members' activations side by side, ``[N, M * H]``, then ``[N, M * C_max]``
(``C_max`` the largest member's class count): those widths are the epoch's
applications, as the issue that added this cell sets the count.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch

from benchmark import counts
from benchmark.models import gcn
from benchmark.reference import train as ref_train


def member_classes(y_child, y_parent) -> List[int]:
    """Each parent's number of distinct child labels over the documents,
    parents in order."""
    y_child, y_parent = np.asarray(y_child), np.asarray(y_parent)
    return [len(np.unique(y_child[y_parent == c])) for c in range(int(y_parent.max()) + 1)]


def initial_params(model: dict, n_nodes: int, c_list: List[int], seed: int,
                   device: torch.device) -> List[Dict[str, torch.Tensor]]:
    """Each member's leaves (``gcn.leaves`` at its class count), filled from
    one ``torch.rand`` on the device, members in order, as
    ``benchmark/weights.py`` fills one model's."""
    leaves = [gcn.leaves(model, n_nodes, c) for c in c_list]
    sizes = [math.prod(shape) for member in leaves for _, shape, _ in member]
    gen = torch.Generator(device=device).manual_seed(seed)
    parts = iter(torch.split(
        torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0), sizes))
    return [{name: next(parts).view(shape).mul(lim) for name, shape, lim in member}
            for member in leaves]


def member_dropout_seed(seed: int, member: int) -> int:
    """The seed of member ``member``'s dropout generator: the trainer's rule
    (``reference/train.py::dropout_seed``) at ``seed + 1 + member``, so that
    every member draws a stream of its own."""
    return ref_train.dropout_seed(seed + 1 + member)


def spmm_widths(model: dict, c_list: List[int]) -> List[int]:
    """The widths of an epoch's ``A_hat`` applications: the train step's two
    forward ones, ``M * H`` and ``M * C_max``, then their gradients in reverse
    (a 2-layer member; its first layer multiplies identity features)."""
    if int(model["n_gcn"]) != 2:
        raise NotImplementedError("the count is of 2-layer members")
    m = len(c_list)
    fwd = [m * int(model["n_hidden"]), m * max(c_list)]
    return fwd + fwd[::-1]


def spmm_least_s_per_epoch(model: dict, n_nodes: int, n_edges: int, c_list: List[int],
                           precision: dict) -> float:
    """The least time an epoch's applications could take on the card: per
    application the larger of its bytes (``counts.spmm_bytes``) over the HBM
    peak and its operations, 2 an edge and column, over the precision's."""
    return sum(max(counts.spmm_bytes(n_nodes, n_edges, w) / counts.H100_PEAK["hbm_bytes_per_s"],
                   2 * n_edges * w / counts.peak_flops(precision))
               for w in spmm_widths(model, c_list))


def flops_per_epoch(model: dict, n_nodes: int, n_edges: int, c_list: List[int]) -> int:
    """Operations of one batched train step, with ``nnz = E + N`` (self-loops
    included): each aggregation ``2 nnz w`` at the widths of
    :func:`spmm_widths`, and each member's ``[N, H] x [H, C_m]`` product
    three times (forward and two gradients) at its own class count, without
    the block-diagonal's zeros: ``2 nnz (2 M H + 2 M C_max) + 6 N H sum(C_m)``.
    Elementwise work, the loss and the optimizer are not counted."""
    n, nnz = int(n_nodes), int(n_edges) + int(n_nodes)
    h = int(model["n_hidden"])
    return sum(2 * nnz * w for w in spmm_widths(model, c_list)) + sum(
        3 * 2 * n * h * c for c in c_list)
