"""Model kind ``egcn``: the reference system's EGCN (BeFranke/PyTextGCN
``textgcn/lib/models.py:28-52``): ``Linear(N, E) + SELU + dropout`` on
identity features (so ``W_e + b_e``) in front of the GCN stack, with dropout
after every GCN layer, the logits included (the reference's loop condition
over ``layers[1:]`` is always true)."""

from __future__ import annotations

import math
from typing import List, Tuple

import torch

from benchmark.models import gcn


def leaves(model: dict, n_nodes: int, n_classes: int) -> List[Tuple[str, tuple, float]]:
    """The embedding's weight and bias, ``U(+-1 / sqrt(fan_in))``
    (torch.nn.Linear), then the stack's."""
    e = int(model["embedding_dim"])
    lim = 1.0 / math.sqrt(n_nodes)
    return [("embed.w", (n_nodes, e), lim), ("embed.b", (e,), lim)] + gcn.stack_leaves(
        gcn.widths(model, e, n_classes))


spmm_widths = gcn.spmm_widths


def flops_per_epoch(model: dict, n_nodes: int, n_edges: int, n_classes: int) -> int:
    """The GCN stack's (``gcn.flops_per_epoch``) with every dense product
    counted, the first ``[N, E] x [E, H]`` included: ``8 N E H`` more."""
    n = int(n_nodes)
    return gcn.flops_per_epoch(model, n, n_edges, n_classes) + 8 * n * int(
        model["embedding_dim"]) * int(model["n_hidden"])


def forward(model: dict, p: dict, spmm, mm, drop):
    h = drop(torch.selu(p["embed.w"] + p["embed.b"]))
    for i in range(int(model["n_gcn"])):
        h = drop(spmm(mm(h, p[f"layers.{i}.w"])) + p[f"layers.{i}.b"])
    return h
