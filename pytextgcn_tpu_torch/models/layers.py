"""Parameter initializers, dropout, the dense layer and the BiLSTM.

Port of ``pytextgcn_tpu/models/layers.py``. Random numbers come from an
explicit ``torch.Generator``; they cannot match JAX's threefry stream, so
parity tests share parameters (``models/gcn.py::load_jax_params``) and run
with dropout 0.

The JAX package runs its LSTM as a ``lax.scan``; here it is
``torch.nn.LSTM`` (dense work, no Pallas kernel behind it), with the same
gate order i, f, g, o: JAX's ``wi`` ``[in, 4H]`` is ``weight_ih_l0``
transposed, ``wh`` is ``weight_hh_l0`` transposed, ``bi`` / ``bh`` are
``bias_ih_l0`` / ``bias_hh_l0``; the backward direction is the ``_reverse``
set.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn


def _uniform(shape: Sequence[int], limit: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=torch.float32).uniform_(
        -limit, limit, generator=generator)


def glorot(shape: Sequence[int], generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Glorot/Xavier uniform over ``[fan_in, fan_out]`` — torch-geometric
    1.6.3 GCNConv weight init."""
    return _uniform(shape, math.sqrt(6.0 / (shape[0] + shape[1])), generator)


def kaiming_uniform(shape: Sequence[int],
                    generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """torch.nn.Linear default weight init (kaiming_uniform, a=sqrt(5)) for a
    ``[in, out]`` weight: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return _uniform(shape, 1.0 / math.sqrt(shape[0]), generator)


def linear_init(in_dim: int, out_dim: int,
                generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
    """torch.nn.Linear-style init: kaiming weights + uniform bias."""
    return {
        "w": kaiming_uniform((in_dim, out_dim), generator),
        "b": _uniform((out_dim,), 1.0 / math.sqrt(in_dim), generator),
    }


def dropout(x: torch.Tensor, rate: float, train: bool,
            generator: Optional[torch.Generator] = None,
            rows: Optional[Tuple[int, int]] = None,
            cols: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Inverted dropout (torch.nn.functional.dropout semantics) with the
    keep mask drawn from ``generator``, which must live on x's device.

    ``rows``: ``(N, lo)`` when x holds rows ``[lo, lo + len(x))`` of an
    ``[N, ...]`` activation (a halo rank's, ``ops/spmm.py::row_block``):
    the full ``[N, ...]`` mask is drawn and x takes its rows, rows past N
    dropped, so every rank seeded alike draws the single-device masks.
    ``cols``: ``(W, lo)`` when the matrix x holds columns ``[lo, lo +
    x.shape[1])`` of a ``[., W]`` activation (a tensor-parallel rank's,
    parallel/tensor.py): the full-width mask is drawn and x takes its
    columns."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = x.shape if rows is None else (rows[0], *x.shape[1:])
    if cols is not None:
        shape = (shape[0], cols[0])
    mask = torch.rand(shape, generator=generator, device=x.device) < keep
    if cols is not None:
        mask = mask[:, cols[1]:cols[1] + x.shape[1]]
    if rows is not None:
        mask = mask[rows[1]:rows[1] + x.shape[0]]
        if mask.shape[0] < x.shape[0]:
            mask = torch.cat([mask, mask.new_zeros((x.shape[0] - mask.shape[0],
                                                    *x.shape[1:]))])
    return torch.where(mask, x / keep, 0.0)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` ``[in, out]`` (the JAX layout) and the
    torch.nn.Linear-style init of :func:`linear_init`."""

    def __init__(self, in_dim: int, out_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        p = linear_init(in_dim, out_dim, generator)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


def bilstm(in_dim: int, hidden: int,
           generator: Optional[torch.Generator] = None) -> nn.LSTM:
    """One bidirectional LSTM layer over axis 1 of ``[B, T, in_dim]``,
    giving ``[B, T, 2 * hidden]`` (forward, then backward). Every weight and
    bias is drawn from U(-1/sqrt(hidden), 1/sqrt(hidden)), torch's and the
    JAX package's ``lstm_init`` distribution, from ``generator``."""
    lstm = nn.LSTM(in_dim, hidden, batch_first=True, bidirectional=True)
    limit = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        for p in lstm.parameters():
            p.copy_(_uniform(p.shape, limit, generator))
    return lstm


def stacked_bilstm(x: torch.Tensor, fwd: Sequence[torch.Tensor],
                   bwd: Sequence[torch.Tensor]) -> torch.Tensor:
    """M bidirectional LSTM layers at once, each on its own batch: ``x``
    ``[M, B, T, C]`` -> ``[M, B, T, 2H]`` (forward, then backward), as
    ``torch.nn.LSTM(batch_first=True, bidirectional=True)`` of member m
    gives it for ``x[m]``. ``fwd`` / ``bwd``: each direction's
    ``(weight_ih [M, 4H, C], weight_hh [M, 4H, H], bias_ih [M, 4H],
    bias_hh [M, 4H])``, the members' ``nn.LSTM`` parameters stacked. Per
    direction the input gates of every step are one batched product and
    each step adds one batched recurrent product (torch's gate order i, f,
    g, o); the batched per-label ensemble runs its JK members' LSTMs so, where
    cuDNN would take one call per member."""
    m, b, t, c = x.shape
    outs = []
    for (w_ih, w_hh, b_ih, b_hh), steps in ((fwd, range(t)), (bwd, range(t - 1, -1, -1))):
        hid = w_hh.shape[-1]
        gates_x = torch.bmm(x.reshape(m, b * t, c), w_ih.transpose(1, 2)).reshape(
            m, b, t, 4 * hid) + (b_ih + b_hh)[:, None, None, :]
        h = cell = None
        ys = [None] * t
        for k in steps:
            gates = gates_x[:, :, k] if h is None else (
                gates_x[:, :, k] + torch.bmm(h, w_hh.transpose(1, 2)))
            i, f, g, o = gates.chunk(4, dim=-1)
            cell = torch.sigmoid(i) * torch.tanh(g) if cell is None else (
                torch.sigmoid(f) * cell + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(cell)
            ys[k] = h
        outs.append(torch.stack(ys, dim=2))
    return torch.cat(outs, dim=-1)


# JAX lstm_init leaf -> (nn.LSTM attribute stem, stored transposed)
LSTM_LEAVES = {"wi": ("weight_ih_l0", True), "wh": ("weight_hh_l0", True),
               "bi": ("bias_ih_l0", False), "bh": ("bias_hh_l0", False)}
