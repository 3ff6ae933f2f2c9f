"""Output-row-restricted SpMM: aggregate into a subset of rows only.

Port of ``pytextgcn_tpu/ops/restricted.py``. The training step's loss reads
the final layer's logits at the train rows alone; every other row of its
aggregation is dead work, and its cotangent is exactly zero. Restricting
the head's SpMM to the train documents cuts 2 of the step's 4
applications to the edges into those rows (word-word edges, most of a
TextGCN graph, never reach a document row).

Three bodies, one populated:

* CSR: the CSR kernel (:mod:`.spmm_cuda`) on a rectangular plan pair,
  forward ``[M, N]`` (M train rows out of N inputs) and transpose
  ``[N, M]`` for the gradient;
* hybrid: ``D_r @ x_hot`` with ``D_r`` the ``[M, K]`` src-hot block of the
  restricted edges, a plain f32 product (``torch.matmul``, TF32 off, as
  the JAX package leaves it to XLA), plus the src-cold residual on the CSR
  kernel or the segment path. It needs no weight symmetry: the transposed
  hot-destination term of the full hybrid exists only for hot output rows;
* segment: gather and ``index_add``.

The self term is ``self_w[rows] * x[rows]``. Gradients are exact; for a
GCN, whose dropout sits on hidden layers, a masked-head train step
computes the full-output step's losses and gradients.

``hot_k='auto'`` picks K with the JAX package's restricted cost model
(:func:`choose_restricted_k`) on H100 constants; it has no tile-padding
term, since the CSR plan pads nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph, gcn_normalize_np
from ..utils import resolve_device
from . import hybrid
from .hybrid import (csr_edge_ns, dense_block_device, dense_block_host, hot_set,
                     segment_arrays, segment_edge_ns, segment_sum)
from .spmm_cuda import _COMPUTE_DTYPES, SpmmPlan, build_csr_plan, spmm_plan

# The restricted head's dense product, ``[M, K] @ [K, H]`` with M the train
# rows: its slab's bytes per second (at H = 8) and its f32 flops per second
# (at the head's H = 43; bf16 D runs the same f32 product on bf16 values),
# torch.matmul timed by chip_smoke.py phase 11 on an NVIDIA H100 80GB HBM3
# at 700 W (synthetic-amazon, 50k documents: M = 36,000, K = 4096).
_SLAB_BPS = 1.74e12
_SLAB_FLOPS = 1.43e13
RESTRICTED_CANDIDATES = (512, 1024, 2048, 4096, 8192)


@dataclasses.dataclass
class RestrictedAdj:
    """Rows ``rows`` of a normalized adjacency, its self-loop diagonal
    included, as tensors on one device.

    rows:      int64 [M] global output row ids, ascending.
    self_rows: f32 [M] the self-loop diagonal at those rows.
    hot_ids / d_rows: the hybrid body, int64 [K] and [M, K] (else None).
    res:       CSR plans, forward [M, N] and transpose [N, M], over all
               restricted edges (CSR body) or the src-cold ones (hybrid).
    seg_src / seg_dst / seg_w: the same edges for the segment path, with
               ``seg_dst`` local to ``rows``.
    n_resid:   the restricted edges outside the hot block (all of them
               without one).
    floor_spmm_ns: the JAX package's floor of one application: the
               ``[M, K]`` slab at ``_HBM_BPS`` plus ``n_resid`` edges at
               ``_GATHER_NS`` each (ops/hybrid.py).
    """

    rows: torch.Tensor
    self_rows: torch.Tensor
    n_nodes: int
    m: int
    k: int = 0
    hot_ids: Optional[torch.Tensor] = None
    d_rows: Optional[torch.Tensor] = None
    res: Optional[SpmmPlan] = None
    seg_src: Optional[torch.Tensor] = None
    seg_dst: Optional[torch.Tensor] = None
    seg_w: Optional[torch.Tensor] = None
    compute_dtype: str = "float32"
    n_edges: int = 0
    n_resid: int = 0
    floor_spmm_ns: float = 0.0


def choose_restricted_k(r_src, n_nodes: int, m: int, h: int = 128, itemsize: int = 4,
                        candidates=RESTRICTED_CANDIDATES,
                        slab_bps: Optional[float] = None, slab_flops: Optional[float] = None,
                        edge_ns: Optional[float] = None,
                        seg_ns: Optional[float] = None) -> int:
    """K minimizing the restricted head's modeled cost (0: no hot set), the
    JAX package's restricted model: the residual is exactly the src-cold
    edges (every destination is a kept row), priced at the cheaper of the
    CSR kernel and the segment path, and ``D_r`` streams once per
    application. ``r_src``: the restricted edges' sources. The rates
    default to the H100 constants at width ``h``."""
    slab_bps = _SLAB_BPS if slab_bps is None else slab_bps
    slab_flops = _SLAB_FLOPS if slab_flops is None else slab_flops
    edge_ns = csr_edge_ns(h) if edge_ns is None else edge_ns
    seg_ns = segment_edge_ns(h) if seg_ns is None else seg_ns
    per_edge = min(edge_ns, seg_ns)
    r_src = np.asarray(r_src, np.int64)
    deg = np.bincount(r_src, minlength=n_nodes)
    rank = np.empty(n_nodes, np.int64)
    rank[np.argsort(-deg, kind="stable")] = np.arange(n_nodes)
    src_rank = rank[r_src]
    best_k, best_t = 0, len(r_src) * per_edge
    for cand in candidates:
        if cand >= n_nodes or m * cand * itemsize > 1.5e9:
            continue
        dense_ns = max(m * cand * itemsize / slab_bps, 2 * m * cand * h / slab_flops) * 1e9
        t = dense_ns + int(np.sum(src_rank >= cand)) * per_edge
        if t < best_t:
            best_k, best_t = cand, t
    return best_k


def build_restricted_adj(
    g: TextGraph,
    rows,
    use_pallas: bool = False,
    hot_k: Optional[Union[int, str]] = None,
    compute_dtype: str = "float32",
    resid_mode: str = "auto",
    h_hint: int = 128,
    device: Optional[Union[str, torch.device]] = None,
) -> RestrictedAdj:
    """Host-side build. ``rows``: sorted unique global node ids (the train
    rows). ``hot_k``: as in :mod:`.hybrid` ('auto': the restricted cost
    model at width ``h_hint``; no symmetry needed). Without a hot set the
    body is the CSR kernel's when ``use_pallas`` (and ``resid_mode`` is
    not 'segment'), else the segment path. ``resid_mode``: the hybrid
    body's src-cold residual on the CSR kernel ('pallas'), the segment
    path ('segment') or the cheaper of the two ('auto')."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    device = resolve_device(device)
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    norm_w, self_w = gcn_normalize_np(src, dst, np.asarray(g.edge_w), g.n_nodes)
    rows = np.asarray(rows, np.int64)
    m, n = int(rows.shape[0]), g.n_nodes
    itemsize = _COMPUTE_DTYPES[compute_dtype].itemsize

    local_of = np.full(n, -1, np.int64)
    local_of[rows] = np.arange(m)
    sel = local_of[dst] >= 0
    r_src, r_dst, r_w = src[sel], local_of[dst[sel]], norm_w[sel]

    if hot_k == "auto":
        hot_k = choose_restricted_k(r_src, n, m, h=h_hint, itemsize=itemsize)

    def csr_pair(s, d, w_):
        return SpmmPlan(fwd=build_csr_plan(d, s, w_, m, n, device),
                        bwd=build_csr_plan(s, d, w_, n, m, device),
                        compute_dtype=compute_dtype)

    def segment(s, d, w_):
        return dict(zip(("seg_src", "seg_dst", "seg_w"), segment_arrays(s, d, w_, device)))

    body = {}
    k = 0
    n_resid = int(r_src.shape[0])
    if hot_k:
        k = max(1, int(min(hot_k, n)))
        if k >= 128:
            k = (k // 128) * 128
        hot = hot_set(r_src, n, k)  # by degree among the restricted edges
        hot_rank = np.full(n, -1, np.int64)
        hot_rank[hot] = np.arange(k)
        hsel = hot_rank[r_src] >= 0
        args = (r_dst[hsel], hot_rank[r_src[hsel]], r_w[hsel], m, k)
        if device.type == "cpu":
            d32 = torch.from_numpy(dense_block_host(*args))
        else:
            d32 = dense_block_device(*args, device=device)
        body.update(hot_ids=torch.as_tensor(hot, device=device),
                    d_rows=d32.to(_COMPUTE_DTYPES[compute_dtype]))
        csel = ~hsel
        n_resid = int(csel.sum())
        if n_resid:
            use_csr = resid_mode == "pallas" or (
                resid_mode == "auto" and csr_edge_ns(h_hint) < segment_edge_ns(h_hint))
            cold = (r_src[csel], r_dst[csel], r_w[csel])
            if use_csr:
                body["res"] = csr_pair(*cold)
            else:
                body.update(segment(*cold))
    elif use_pallas and resid_mode != "segment":
        body["res"] = csr_pair(r_src, r_dst, r_w)
    else:
        body.update(segment(r_src, r_dst, r_w))

    floor = m * k * itemsize / hybrid._HBM_BPS * 1e9 + n_resid * hybrid._GATHER_NS
    return RestrictedAdj(
        rows=torch.as_tensor(rows, device=device),
        self_rows=torch.as_tensor(self_w[rows], dtype=torch.float32, device=device),
        n_nodes=n, m=m, k=k, compute_dtype=compute_dtype, n_edges=int(r_src.shape[0]),
        n_resid=n_resid, floor_spmm_ns=float(floor), **body,
    )


def spmm_restricted(adj: RestrictedAdj, x: torch.Tensor) -> torch.Tensor:
    """Rows ``adj.rows`` of ``A_hat @ x``: ``[M, H]`` float32."""
    out = None
    if adj.d_rows is not None:
        x_hot = x.to(_COMPUTE_DTYPES[adj.compute_dtype]).index_select(0, adj.hot_ids)
        # bf16 operands multiply exactly in f32: the bf16 product with an
        # f32 result
        out = torch.matmul(adj.d_rows.float(), x_hot.float())
    if adj.res is not None:
        r = spmm_plan(adj.res, x)
        out = r if out is None else out + r
    if adj.seg_src is not None:
        r = segment_sum(adj.seg_src, adj.seg_dst, adj.seg_w, x, adj.m)
        out = r if out is None else out + r
    self_term = adj.self_rows[:, None] * x.index_select(0, adj.rows)
    return self_term if out is None else out + self_term
