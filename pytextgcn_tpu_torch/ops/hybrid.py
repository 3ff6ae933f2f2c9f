"""Hybrid dense-hot / sparse-cold SpMM decomposition.

Port of ``pytextgcn_tpu/ops/hybrid.py``. Text graphs are Zipfian: a few
thousand *hot* nodes (frequent words) are an endpoint of most edges.
Splitting the adjacency at a hot set of size K:

    out       = D @ x[hot]                      (src in hot)
    out[hot] += D^T @ x - A_hh @ x[hot]         (dst in hot, src not hot)
    out      += A_cc @ x                        (both cold: the residual)

where ``D[n, k] = sum w(hot_k -> n)`` is one dense ``[N, K]`` block that,
by the symmetry of the normalized adjacency (every edge stored in both
directions with the same weight), also serves the transposed role, and
``A_hh = D[hot]`` removes the double-counted hot-hot block. The self-loop
diagonal is added by the caller (:mod:`.spmm`).

The dense pair ``(D @ x[hot], D^T @ x)`` runs in the dual kernel
(:mod:`.fused_dual`) except for f32 'highest' with ``fused`` off, which
runs two f32 ``torch.mm`` as the JAX package runs two XLA dots. The
residual runs on the CSR kernel (:mod:`.spmm_cuda`) with its own forward
and transpose plans. This slice takes an explicit K only: the JAX cost
model that picks K (``choose_hot_k``) rests on TPU constants.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from .fused_dual import fused_dual, fused_dual_split, split_bf16
from .spmm_cuda import _COMPUTE_DTYPES, SpmmPlan, build_plan_from_arrays, spmm_plan

F32_MODES = ("highest", "split2")
DEFAULT_F32_MODE = "split2"


@dataclasses.dataclass
class HybridPlan:
    """Hot-set decomposition of a normalized adjacency (minus self-loops),
    as tensors on one device.

    hot_ids: int64 [K] node ids of the hot set, ascending.
    d_full:  [N, K] ``sum w(hot_k -> n)``: f32, bf16, or, when ``d_lo`` is
             set, the hi half of the bf16 (hi, lo) pair.
    d_lo:    the lo half under the f32 'split2' mode, else None.
    a_hh:    [K, K] hot-hot block ``D[hot_ids]`` (f32 hi + lo under the split).
    res:     CSR kernel plans of the cold-cold residual (None when empty).
    fused:   with f32 'highest', run the dense pair in the dual kernel
             instead of two ``torch.mm``.
    n_resid: residual (cold-cold) edge count.
    """

    hot_ids: torch.Tensor
    d_full: torch.Tensor
    d_lo: Optional[torch.Tensor]
    a_hh: torch.Tensor
    res: Optional[SpmmPlan]
    n_nodes: int
    k: int
    compute_dtype: str = "float32"
    fused: bool = False
    n_resid: int = 0


def check_weight_symmetric(src, dst, w, sel=None):
    """Verify the (selected) edge list is weight-symmetric: every edge
    (i, j, w) has a mirror (j, i, w). The hybrid's hot-destination term
    computes ``D^T @ x``, substituting outgoing hot weights for incoming
    ones, so it is exact only under this symmetry. Raises ValueError on an
    asymmetric input instead of computing a wrong SpMM."""
    if sel is not None:
        src, dst, w = src[sel], dst[sel], w[sel]
    o1 = np.lexsort((w, dst, src))
    o2 = np.lexsort((w, src, dst))
    # symmetric normalization computes (dinv_i*w)*dinv_j vs (dinv_j*w)*dinv_i,
    # which differ in the last ulp
    if not (
        np.array_equal(src[o1], dst[o2])
        and np.array_equal(dst[o1], src[o2])
        and np.allclose(w[o1], w[o2], rtol=1e-5, atol=1e-12)
    ):
        raise ValueError(
            "hybrid SpMM requires a weight-symmetric adjacency (every edge "
            "(i,j,w) mirrored as (j,i,w)) for edges touching the hot set; "
            "this edge list is directed or half-stored. Use the CSR kernel or "
            "the segment path (hybrid_k=None) for non-symmetric operators."
        )


def check_weight_symmetric_fast(src, dst, w, n_nodes: int, seed: int = 0):
    """O(E) randomized audit of weight symmetry, for graphs whose
    construction guarantees it (``TextGraph.weight_symmetric``): the
    multiset {(i, j, w)} equals its transpose iff, for random node vectors
    r1, r2, ``sum w r1[src] r2[dst]`` and ``sum w r1[dst] r2[src]`` agree
    (two draws make a false accept negligible)."""
    rng = np.random.default_rng(seed)
    w = np.asarray(w, np.float64)
    for _ in range(2):
        r1 = rng.standard_normal(n_nodes)
        r2 = rng.standard_normal(n_nodes)
        a = float(np.sum(w * r1[src] * r2[dst]))
        b = float(np.sum(w * r1[dst] * r2[src]))
        scale = float(np.sum(np.abs(w * r1[src] * r2[dst]))) + 1e-30
        if abs(a - b) > 1e-6 * scale:
            raise ValueError(
                "randomized symmetry audit failed: the adjacency is not "
                "weight-symmetric despite TextGraph.weight_symmetric=True"
            )


def dense_block_host(dst_sel, rank_sel, w_sel, n_rows: int, k: int) -> np.ndarray:
    """The ``[n_rows, K]`` hot block accumulated on the host (scipy's COO
    densification sums duplicates)."""
    from scipy import sparse

    m = sparse.coo_matrix(
        (np.asarray(w_sel, np.float32),
         (np.asarray(dst_sel, np.int64), np.asarray(rank_sel, np.int64))),
        shape=(n_rows, k), dtype=np.float32,
    )
    return m.toarray()


def dense_block_device(dst_sel, rank_sel, w_sel, n_rows: int, k: int,
                       device: torch.device) -> torch.Tensor:
    """The same block accumulated on ``device`` with
    ``index_put_(accumulate=True)``: only the selected edges are shipped,
    not the ``[n_rows, K]`` block."""
    d = torch.zeros(n_rows, k, dtype=torch.float32, device=device)
    idx = (torch.as_tensor(np.asarray(dst_sel, np.int64), device=device),
           torch.as_tensor(np.asarray(rank_sel, np.int64), device=device))
    return d.index_put_(idx, torch.as_tensor(np.asarray(w_sel, np.float32), device=device),
                        accumulate=True)


def build_hybrid_plan(
    src,
    dst,
    w,
    n_nodes: int,
    hot_k: Union[int, str],
    compute_dtype: str = "float32",
    validate: Union[bool, str] = True,
    fused: Optional[bool] = None,
    resid_mode: str = "pallas",
    f32_mode: Optional[str] = None,
    device: torch.device = torch.device("cpu"),
) -> Optional[HybridPlan]:
    """Host-side construction. ``hot_k``: the hot-set size (0 = off: returns
    None); it is clamped to N and, from 128 up, rounded down to a multiple
    of 128. ``validate``: True = exact symmetry audit of the hot-touching
    edges, 'fast' = the randomized audit of all edges, False = none.
    ``fused`` (None = off): f32 'highest' runs the dense pair in the dual
    kernel. ``f32_mode`` (None = 'split2'): 'split2' stores D as a bf16
    (hi, lo) pair for the split dual kernel; 'highest' keeps f32 D.
    ``resid_mode``: only 'pallas' (the CSR kernel) is ported."""
    if hot_k == "auto":
        raise NotImplementedError(
            "hybrid_k='auto' needs the cost model's H100 constants, which are not "
            "ported yet (see ROADMAP.md); pass an integer K")
    if resid_mode != "pallas":
        raise NotImplementedError(
            f"resid_mode={resid_mode!r} (the segment/auto residual) is not ported yet "
            "(see ROADMAP.md)")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    f32_mode = f32_mode or DEFAULT_F32_MODE
    if f32_mode not in F32_MODES:
        raise ValueError(f"f32_mode must be one of {F32_MODES}, got {f32_mode!r}")
    if not hot_k:
        return None
    dense_split = compute_dtype == "float32" and f32_mode == "split2"
    device = torch.device(device)

    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    k = int(min(int(hot_k), n_nodes))
    if k >= 128:
        k = (k // 128) * 128
    k = max(1, k)

    deg = np.bincount(src, minlength=n_nodes)
    order = np.argsort(-deg, kind="stable")
    hot_ids = np.sort(order[:k])
    hot_rank = np.full(n_nodes, -1, np.int64)
    hot_rank[hot_ids] = np.arange(k)
    src_hot = hot_rank[src] >= 0
    dst_hot = hot_rank[dst] >= 0
    if validate == "fast":
        check_weight_symmetric_fast(src, dst, w, n_nodes)
    elif validate:
        check_weight_symmetric(src, dst, w, sel=src_hot | dst_hot)

    sel = src_hot
    if device.type == "cpu":
        d32 = torch.from_numpy(dense_block_host(dst[sel], hot_rank[src[sel]], w[sel],
                                                n_nodes, k))
    else:
        d32 = dense_block_device(dst[sel], hot_rank[src[sel]], w[sel], n_nodes, k, device)
    hot_t = torch.as_tensor(hot_ids, device=device)
    d_lo = None
    if dense_split:
        d_full, d_lo = split_bf16(d32)
        a_hh = d_full[hot_t].float() + d_lo[hot_t].float()
    else:
        d_full = d32.to(_COMPUTE_DTYPES[compute_dtype])
        a_hh = d_full[hot_t]
    del d32

    rsel = ~src_hot & ~dst_hot
    n_resid = int(rsel.sum())
    res = None
    if n_resid:
        res = build_plan_from_arrays(src[rsel], dst[rsel], w[rsel], n_nodes,
                                     compute_dtype=compute_dtype, device=device)
    return HybridPlan(
        hot_ids=hot_t, d_full=d_full, d_lo=d_lo, a_hh=a_hh, res=res, n_nodes=n_nodes,
        k=k, compute_dtype=compute_dtype, fused=bool(fused), n_resid=n_resid,
    )


def spmm_hybrid(plan: HybridPlan, x: torch.Tensor) -> torch.Tensor:
    """``(A_hat - diag(self_w)) @ x`` via the hot decomposition, f32 out."""
    cd = _COMPUTE_DTYPES[plan.compute_dtype]
    xc = x.to(cd)
    x_hot = xc.index_select(0, plan.hot_ids)
    if plan.d_lo is not None:
        out, hot_in = fused_dual_split(plan.d_full, plan.d_lo, xc, x_hot)
    elif plan.fused or cd == torch.bfloat16:
        # bf16 products with an f32 result: the dual kernel whether or not
        # fused is asked for (torch.mm would round its output to bf16)
        out, hot_in = fused_dual(plan.d_full, xc, x_hot)
    else:
        out = plan.d_full @ x_hot
        hot_in = plan.d_full.t() @ xc
    # minus the double-counted hot-hot block; bf16 operands multiply exactly
    # in f32, so this is the bf16 product with an f32 result
    hot_in = hot_in - plan.a_hh.float() @ x_hot.float()
    out = out.index_add(0, plan.hot_ids, hot_in)
    if plan.res is not None:
        out = out + spmm_plan(plan.res, x)
    return out
