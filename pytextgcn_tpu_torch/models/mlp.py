"""TF-IDF + MLP baseline model.

Port of ``pytextgcn_tpu/models/mlp.py`` (the reference's ``MLP``,
models.py:83-102): a Linear stack with SELU + dropout between layers, whose
first layer consumes sparse TF-IDF document features. The sparse first
layer is an SpMM over the document-term matrix through the same CSR kernel
as the GCN aggregation (``ops/spmm_cuda.py``): one sparse engine for the
whole package.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
from scipy import sparse as sp
from torch import nn

from ..ops.hybrid import segment_sum
from ..ops.spmm_cuda import SpmmPlan, build_csr_plan, spmm_plan
from ..utils import resolve_device
from .layers import Dense, dropout


class SparseMatrix:
    """A sparse ``[B, D]`` matrix (doc-term TF-IDF) as COO tensors on a
    device.

    With ``use_pallas=True`` (the JAX package's name for its kernel path)
    the product runs in the CSR kernel on two rectangular plans: S ``[B,
    D]`` for the forward and Sᵀ ``[D, B]``, whose launch gives the dense
    operand's gradient ``Sᵀ @ g`` in backward. Without it the product is the
    plain gather / ``index_add_`` path, differentiated by autograd.
    """

    def __init__(self, row: torch.Tensor, col: torch.Tensor, data: torch.Tensor,
                 shape: Sequence[int], plan: Optional[SpmmPlan] = None):
        self.row = row
        self.col = col
        self.data = data
        self.shape = tuple(int(s) for s in shape)
        self.plan = plan  # forward and transpose CSR plans, or None

    @staticmethod
    def from_scipy(m: sp.spmatrix, use_pallas: bool = False, compute_dtype: str = "float32",
                   device: Optional[Union[str, torch.device]] = None) -> "SparseMatrix":
        """``device``: None means the GPU (raises without one)."""
        dev = resolve_device(device)
        coo = m.tocoo()
        row, col = coo.row.astype(np.int64), coo.col.astype(np.int64)
        data = coo.data.astype(np.float32)
        plan = None
        if use_pallas:
            b, d = m.shape
            plan = SpmmPlan(fwd=build_csr_plan(row, col, data, b, d, dev),
                            bwd=build_csr_plan(col, row, data, d, b, dev),
                            compute_dtype=compute_dtype)
        put = lambda a: torch.as_tensor(a, device=dev)
        return SparseMatrix(put(row), put(col), put(data), m.shape, plan)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def matmul(self, w: torch.Tensor) -> torch.Tensor:
        """(sparse ``[B, D]``) @ (dense ``[D, H]``), float32 out."""
        if self.plan is not None:
            return spmm_plan(self.plan, w)
        return segment_sum(self.col, self.row, self.data, w, self.shape[0])

    def to_scipy(self) -> sp.csr_matrix:
        return sp.csr_matrix((self.data.cpu().numpy(), (self.row.cpu().numpy(),
                                                        self.col.cpu().numpy())),
                             shape=self.shape)

    def slice_rows(self, idx: np.ndarray) -> "SparseMatrix":
        """Host-side row selection (split handling), on the same device and
        path."""
        cd = self.plan.compute_dtype if self.plan is not None else "float32"
        return SparseMatrix.from_scipy(self.to_scipy()[idx], use_pallas=self.plan is not None,
                                       compute_dtype=cd, device=self.device)


class MLP(nn.Module):
    """Matches reference ``MLP(in_channels, out_channels, hidden, dropout)``
    (models.py:83-102): SELU after each hidden layer, dropout after each
    SELU, no activation on the first product's input. Parameters are drawn
    on the CPU from ``generator`` with ``linear_init`` (models/layers.py);
    move the model with ``.to(device)``."""

    def __init__(self, in_dim: int, out_dim: int, hidden: List[int], dropout: float = 0.5,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if not hidden:
            raise ValueError("MLP needs at least one hidden layer")
        self.in_dim = in_dim
        self.out_dim = out_dim
        self.hidden = list(hidden)
        self.dropout = dropout
        dims = [in_dim] + self.hidden + [out_dim]
        self.layers = nn.ModuleList(Dense(d_in, d_out, generator)
                                    for d_in, d_out in zip(dims[:-1], dims[1:]))

    def jax_tree(self) -> Dict[str, Any]:
        """The JAX package's parameter tree ``{"layers": [{"w", "b"}, ...]}``,
        each leaf a ``(parameter, stored_transposed)`` pair."""
        return {"layers": [{"w": (layer.w, False), "b": (layer.b, False)}
                           for layer in self.layers]}

    def forward(self, x: Union[torch.Tensor, SparseMatrix], *, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Logits ``[B, out_dim]`` of a dense ``[B, D]`` tensor or a
        :class:`SparseMatrix`; ``generator`` draws the dropout masks when
        ``train``."""
        first, *rest = self.layers
        h = (x.matmul(first.w) if isinstance(x, SparseMatrix) else x @ first.w) + first.b
        for layer in rest:
            h = dropout(torch.selu(h), self.dropout, train, generator)
            h = h @ layer.w + layer.b
        return h
