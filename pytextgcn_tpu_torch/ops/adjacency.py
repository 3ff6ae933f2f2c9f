"""Normalized adjacency operator.

Port of ``pytextgcn_tpu/ops/adjacency.py``: ``A_hat = D^-1/2 (A + I)
D^-1/2`` is computed once per graph on the host; self-loops are carried as
a separate diagonal vector instead of E extra edges.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph, gcn_normalize_np
from ..train.profiling import stage
from ..utils import resolve_device
from .hybrid import HybridPlan, build_hybrid_plan
from .plan_cache import load_or_build
from .spmm_cuda import SpmmPlan, build_plan_from_arrays


@dataclasses.dataclass
class NormAdj:
    """Symmetrically normalized adjacency in COO form + self-loop diagonal,
    as tensors on one device.

    ``plan`` optionally holds the CSR kernel plan (:mod:`.spmm_cuda`) or a
    hybrid plan (:mod:`.hybrid`); when present the SpMM runs through it,
    otherwise through the plain gather + ``index_add_`` path
    (:func:`.spmm.spmm_segment`).
    """

    src: torch.Tensor  # int64 [E]
    dst: torch.Tensor  # int64 [E]
    w: torch.Tensor  # float32 [E]
    self_w: torch.Tensor  # float32 [N]
    n_nodes: int
    plan: Optional[Union[SpmmPlan, HybridPlan]] = None

    @staticmethod
    def from_graph(
        g: TextGraph,
        use_pallas: bool = False,
        pallas_dtype: str = "float32",
        device: Optional[Union[str, torch.device]] = None,
        hybrid_k: Optional[Union[int, str]] = None,
        hybrid_fused: Optional[bool] = None,
        hybrid_f32_mode: Optional[str] = None,
        hybrid_resid: str = "pallas",
        hybrid_batch: int = 1,
        h_hint: int = 128,
        plan_cache: Optional[str] = None,
    ) -> "NormAdj":
        """``use_pallas`` keeps the JAX package's name for "run the
        aggregation in the hand-written kernel": it builds the CSR plan.
        ``pallas_dtype``: 'float32' or 'bfloat16' (x read as bf16, f32
        accumulation). ``hybrid_k``: the dense-hot/sparse-cold
        decomposition (:mod:`.hybrid`) with a hot set of that size (0 or
        None = off), or 'auto' (the cost model, at width ``h_hint`` for
        ``hybrid_batch`` members applying the operator together); it
        implies the CSR kernel, which takes the whole graph when 'auto'
        declines a hot set. ``hybrid_fused``: the dual kernel for the f32
        'highest' dense pair (None = off). ``hybrid_f32_mode``: 'split2'
        (None) or 'highest'. ``hybrid_resid``: the cold-cold residual on
        the CSR kernel ('pallas'), the segment path ('segment') or the
        cheaper of the two ('auto'). ``plan_cache``: a directory of
        persisted plans (:mod:`.plan_cache`)."""
        device = resolve_device(device)
        src = np.asarray(g.edge_src)
        dst = np.asarray(g.edge_dst)
        with stage("operator.normalize"):
            norm_w, self_w = gcn_normalize_np(src, dst, g.edge_w, g.n_nodes)
        if hybrid_k == 0:
            hybrid_k = None

        def build():
            plan = None
            if hybrid_k is not None:
                plan = build_hybrid_plan(
                    src, dst, norm_w, g.n_nodes, hot_k=hybrid_k, compute_dtype=pallas_dtype,
                    fused=hybrid_fused, f32_mode=hybrid_f32_mode, device=device,
                    resid_mode=hybrid_resid, batch=hybrid_batch, h_hint=h_hint,
                    # symmetric normalization keeps a construction-guaranteed
                    # weight symmetry: the randomized audit is enough
                    validate="fast" if getattr(g, "weight_symmetric", False) else True,
                )
            if plan is None and (use_pallas or hybrid_k is not None):
                plan = build_plan_from_arrays(
                    src, dst, norm_w, g.n_nodes, compute_dtype=pallas_dtype, device=device
                )
            return plan

        params = dict(use_pallas=bool(use_pallas or hybrid_k is not None),
                      pallas_dtype=pallas_dtype)
        if hybrid_k is not None:
            params.update(hybrid_k=hybrid_k, hybrid_fused=hybrid_fused,
                          hybrid_f32_mode=hybrid_f32_mode, hybrid_resid=hybrid_resid,
                          hybrid_batch=hybrid_batch, h_hint=h_hint)
        # the plan, built (copies to the device included) or loaded
        with stage("operator.csr_plan"):
            plan = load_or_build(plan_cache, g, src, dst, norm_w, device, build, **params)
        with stage("operator.upload"):
            return NormAdj(
                src=torch.as_tensor(src.astype(np.int64), device=device),
                dst=torch.as_tensor(dst.astype(np.int64), device=device),
                w=torch.as_tensor(norm_w, device=device),
                self_w=torch.as_tensor(self_w, device=device),
                n_nodes=g.n_nodes,
                plan=plan,
            )
