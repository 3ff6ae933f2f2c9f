"""Jumping-Knowledge network (LSTM-attention fusion).

Port of ``pytextgcn_tpu/models/jk.py`` (the reference's
``JumpingKnowledgeNetwork``, models.py:55-81): a GCN stack whose per-layer
activations are fused by torch-geometric's ``JumpingKnowledge(mode="lstm")``
— a bidirectional LSTM over the layer axis with per-layer scalar attention —
followed by an activation, dropout and a linear head. The BiLSTM hidden
size follows PyG's formula ``(num_layers * channels) // 2`` per direction.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..ops.adjacency import NormAdj
from ..ops.features import NodeFeatures
from ..ops.spmm import row_block, spmm
from .gcn import GraphConv
from .layers import LSTM_LEAVES, Dense, bilstm, dropout

JK_NO_MASKED_HEAD = ("the JK network has no masked head (masked_head=True): its LSTM "
                     "reads every layer's full output")


class JumpingKnowledgeNetwork(nn.Module):
    """GCN layers ``[in, hidden, ..., hidden]`` (``n_gcn`` of them), each
    followed by dropout, fused by the BiLSTM attention, then ``activation``,
    dropout and the head. Parameters are drawn on the CPU from
    ``generator``; move the model with ``.to(device)``."""

    def __init__(
        self,
        in_dim: int,
        out_dim: int,
        n_gcn: int = 2,
        n_hidden_gcn: int = 64,
        dropout: float = 0.5,
        activation: Callable[[torch.Tensor], torch.Tensor] = torch.relu,
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
        self.activation = activation
        dims = [in_dim] + [n_hidden_gcn] * n_gcn
        self.layers = nn.ModuleList(
            GraphConv(d_in, d_out, generator) for d_in, d_out in zip(dims[:-1], dims[1:])
        )
        lstm_hidden = (n_gcn * n_hidden_gcn) // 2
        self.lstm = bilstm(n_hidden_gcn, lstm_hidden, generator)
        self.att = Dense(2 * lstm_hidden, 1, generator)
        self.head = Dense(n_hidden_gcn, out_dim, generator)

    def jax_tree(self) -> Dict[str, Any]:
        """The JAX package's parameter tree, each leaf a ``(parameter,
        stored_transposed)`` pair (the LSTM weights are stored transposed
        there)."""
        def lstm_dir(suffix):
            return {name: (getattr(self.lstm, stem + suffix), transposed)
                    for name, (stem, transposed) in LSTM_LEAVES.items()}

        dense = lambda m: {"w": (m.w, False), "b": (m.b, False)}
        return {
            "layers": [dense(layer) for layer in self.layers],
            "lstm": {"fwd": lstm_dir(""), "bwd": lstm_dir("_reverse")},
            "att": dense(self.att),
            "head": dense(self.head),
        }

    def forward(self, adj: NormAdj, feats: NodeFeatures, *, train: bool = False,
                generator: Optional[torch.Generator] = None, adj_out=None) -> torch.Tensor:
        if adj_out is not None:
            # the JAX package's JumpingKnowledgeNetwork.apply takes no adj_out
            # (models/jk.py:63): its masked head fails there, and is refused here
            raise ValueError(JK_NO_MASKED_HEAD)
        rows = row_block(adj)  # a halo rank's rows (ops/spmm.py)
        first, *rest = self.layers
        h = spmm(adj, feats.matmul(first.w)) + first.b
        # the reference applies dropout after every layer (models.py:70-73)
        acts = [dropout(h, self.dropout, train, generator, rows)]
        for layer in rest:
            h = spmm(adj, acts[-1] @ layer.w) + layer.b
            acts.append(dropout(h, self.dropout, train, generator, rows))

        xs = torch.stack(acts, dim=1)  # [N, L, C]
        alpha, _ = self.lstm(xs)  # [N, L, 2H]
        score = torch.softmax(self.att(alpha).squeeze(-1), dim=-1)  # [N, L]
        h = (xs * score[:, :, None]).sum(dim=1)  # [N, C]

        h = dropout(self.activation(h), self.dropout, train, generator, rows)
        return self.head(h)
