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
and transpose plans (``resid_mode='pallas'``, the JAX package's name for
its kernel), or on gather / ``index_add_`` (``'segment'``), or on whichever
of the two the cost model prices lower (``'auto'``).

``hot_k='auto'`` picks K with the JAX package's cost model
(:func:`choose_hot_k`, :func:`_predict_cost_ns`) on constants measured on
an H100 (``chip_smoke.py`` phase 11), never the TPU's. Two changes of
form, each measured: the CSR kernel's time per edge grows with the width H
(it reads H columns of each gathered row), so the per-edge rates are
tables over H (:func:`csr_edge_ns`, :func:`segment_edge_ns`) where the JAX
package has one constant; and a hybrid application pays fixed passes over
``[N, H]`` beyond its dense pair and residual (``_HYBRID_NH_NS``).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Union

import numpy as np
import torch

from .fused_dual import fused_dual, fused_dual_split, split_bf16
from .spmm_cuda import _COMPUTE_DTYPES, SpmmPlan, build_plan_from_arrays, spmm_plan

F32_MODES = ("highest", "split2")
DEFAULT_F32_MODE = "split2"
RESID_MODES = ("pallas", "segment", "auto")

# ---------------------------------------------------------------- cost model
#
# Constants of the JAX package's cost model, measured on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit by chip_smoke.py (phase 11 fits them from its
# own timings and prints the fit beside these values), on the 50k-document
# synthetic-amazon graph (N = 77,923, E = 13,310,312) with f32 TF32 off.
#
# The dense pair's D stream, bytes per second: the split kernel at K = 4096,
# H = 43, where it is bound by reading D (a bf16 hi/lo pair, 4 bytes an
# element).
_HBM_BPS = 1.265e12
# f32 dense products, base flops per second (2 per multiply-add): two f32
# torch.mm of the dense pair at K = 4096, H = 100 (the f32 dual kernel runs
# within 8% of them), and the K x K hot-hot correction.
_MXU_F32_HIGHEST = 3.76e13
# bf16 dual kernel over the f32 rate, at K = 4096, H = 100.
_MXU_BF16_FACTOR = 3.69
# the split dual kernel, base flops per second at K = 4096, H = 100 (three
# bf16 passes a product, bound by the rate they are issued at there).
_MXU_SPLIT_DENSE = 7.86e13
# the CSR plan pads nothing: a residual edge is one edge of the kernel.
_PAD_FACTOR = 1.0
# ns per edge of the CSR kernel (whole-graph forward plan, one launch) and
# of the segment path (gather, weight, index_add), by width H. The rate
# grows with H: each edge reads H columns of its row. Where the JAX package
# has one constant, these are tables.
_CSR_EDGE_NS = {1: 0.01115, 6: 0.01147, 9: 0.01366, 10: 0.01371, 11: 0.01345,
                14: 0.01594, 32: 0.01578, 43: 0.02394, 70: 0.03642, 100: 0.04441,
                219: 0.10296, 600: 0.24992}
_SEGMENT_EDGE_NS = {1: 0.1202, 14: 0.2527, 43: 0.6575, 100: 1.6896, 219: 3.9395}
# The one term the JAX form lacks: what a hybrid application costs beyond
# its dense pair and its residual's edges (the x_hot gather, the split
# prologue, the hot-hot correction, the scatter of the hot rows, the sum of
# the residual, each a pass over [N, H], and their launches), in ns per
# element of [N, H]: the measured application time less the modeled one, at
# K = 512 to 4096, H = 100. Without it the model picks K = 512 on the
# amazon graph, which runs 13% slower than K = 0.
_HYBRID_NH_NS = 0.0212
# bump when the constants above change enough to move choose_hot_k's
# choice: the plan cache folds it into the keys of 'auto' plans
COST_MODEL_VERSION = 1
# The floor's price of a residual edge: the bytes that the edge must read
# from HBM whatever the caches hold, its source index and its weight, at
# the card's streaming rate as ops/probe.py measures it (stream_bps,
# 2.789e12 B/s, read by chip_smoke.py phase 14 (a) on an NVIDIA H100 80GB
# HBM3 at a 700 W power limit). The edge's row of x is not charged: the CSR
# kernel runs an edge at H = 100 in 0.044 ns (_CSR_EDGE_NS), less than a
# 400-byte row takes at that rate (0.143 ns), because the rows come from
# cache (x is 31 MB on the 50k-document graph, L2 holds 50 MB). The floor
# leaves out _HYBRID_NH_NS, which is an observed overhead, not a floor.
RESID_EDGE_BYTES = 8
_STREAM_BPS = 2.789e12
_GATHER_NS = RESID_EDGE_BYTES / _STREAM_BPS * 1e9


def _by_width(table: dict, h: int) -> float:
    """Linear interpolation of a per-width table; beyond its last width the
    rate grows in proportion to H, below its first it stays."""
    ws = sorted(table)
    if h <= ws[0]:
        return table[ws[0]]
    if h >= ws[-1]:
        return table[ws[-1]] * h / ws[-1]
    return float(np.interp(h, ws, [table[w] for w in ws]))


def csr_edge_ns(h: int) -> float:
    """ns per edge of the CSR kernel at width ``h``."""
    return _by_width(_CSR_EDGE_NS, h)


def segment_edge_ns(h: int) -> float:
    """ns per edge of the segment path at width ``h``."""
    return _by_width(_SEGMENT_EDGE_NS, h)


def _predict_cost_ns(n_nodes: int, n_edges: int, resid_edges: float, k: int, h: int,
                     itemsize: int, d_reads: int = 2, batch: int = 1,
                     dense_split: bool = False, edge_ns: Optional[float] = None) -> float:
    """Modeled cost of one application of a K-hot decomposition, the JAX
    package's form: the dense pair (``d_reads`` streams of the ``[N, K]``
    block, 1 in the dual kernels), the larger of its bytes and its flops
    time, plus the ``K x K`` correction, plus the residual's edges at the
    CSR kernel's rate (``resid_edges`` in its edge units); and, beyond the
    JAX form, the hybrid's fixed passes over ``[N, H]``
    (``_HYBRID_NH_NS``). ``batch`` members applying the same operator share
    D's stream and pay the rest each."""
    if edge_ns is None:
        edge_ns = csr_edge_ns(h)
    dense_ns = _dense_ns(n_nodes, k, h, itemsize, d_reads, batch, dense_split)
    fixed_ns = _HYBRID_NH_NS * n_nodes * h * batch
    return dense_ns + fixed_ns + resid_edges * edge_ns * batch


def _dense_ns(n_nodes: int, k: int, h: int, itemsize: int, d_reads: int, batch: int,
              dense_split: bool) -> float:
    """The dense pair's modeled ns: the larger of its bytes and its flops
    time, plus the ``K x K`` correction."""
    dense_bytes = (d_reads * n_nodes * k + k * k) * itemsize
    dense_flops = 2 * (2 * n_nodes * k) * h * batch
    kk_ns = 2 * k * k * h * batch / _MXU_F32_HIGHEST * 1e9
    if dense_split:
        mxu = _MXU_SPLIT_DENSE
    elif itemsize == 4:
        mxu = _MXU_F32_HIGHEST
    else:
        mxu = _MXU_BF16_FACTOR * _MXU_F32_HIGHEST
    return max(dense_bytes / _HBM_BPS, dense_flops / mxu) * 1e9 + kk_ns


def plan_floor_ns(plan: "HybridPlan", h: int) -> float:
    """The floor of one application of ``plan`` at width ``h``, the JAX
    package's form: the dense pair at zero residual plus the residual's
    edges at ``_GATHER_NS`` each (no ``_HYBRID_NH_NS`` term). D streams
    once in the dual kernels (split, bf16, f32 fused), twice in two
    ``torch.mm``."""
    split = plan.d_lo is not None
    itemsize = _COMPUTE_DTYPES[plan.compute_dtype].itemsize
    d_reads = 1 if (plan.fused or split or itemsize == 2) else 2
    return (_dense_ns(plan.n_nodes, plan.k, h, itemsize, d_reads, 1, split)
            + plan.n_resid * _GATHER_NS)


def choose_hot_k(src, n_nodes: int, h: int = 128, itemsize: int = 4,
                 candidates=(0, 512, 1024, 2048, 4096, 8192, 12288, 16384),
                 dst=None, d_reads: int = 2, batch: int = 1,
                 segment_resid: bool = False, dense_split: bool = False,
                 edge_ns: Optional[float] = None, seg_ns: Optional[float] = None) -> int:
    """K minimizing the modeled cost (0: the hybrid does not pay), as the
    JAX package's ``choose_hot_k`` picks it. With ``dst`` the cold-cold
    residual is counted per candidate; without it, estimated from the
    degree coverage. K = 0 is the whole graph on the CSR kernel (on the
    segment path with ``segment_resid``). ``edge_ns`` / ``seg_ns``: the CSR
    kernel's and the segment path's ns per edge (None: :func:`csr_edge_ns`
    and :func:`segment_edge_ns` at ``h``)."""
    if edge_ns is None:
        edge_ns = csr_edge_ns(h)
    if seg_ns is None:
        seg_ns = segment_edge_ns(h)
    src = np.asarray(src)
    deg = np.bincount(src, minlength=n_nodes)
    order = np.argsort(-deg, kind="stable")
    e = len(src)
    rank = np.empty(n_nodes, np.int64)
    rank[order] = np.arange(n_nodes)
    r_src = rank[src]
    r_dst = rank[np.asarray(dst)] if dst is not None else None
    cum = np.concatenate([[0], np.cumsum(deg[order])])
    # a residual edge in CSR-edge units
    slot_factor = seg_ns / edge_ns if segment_resid else _PAD_FACTOR
    best_k, best_t = 0, e * slot_factor * edge_ns * batch
    for k in candidates:
        if k == 0 or k >= n_nodes:
            continue
        # the block's memory: worth it only under a cap that grows with
        # the members sharing it
        if n_nodes * k * itemsize > min(1.5e9 * batch, 4e9):
            continue
        if r_dst is not None:
            resid = int(np.sum((r_src >= k) & (r_dst >= k)))
        else:
            cov = cum[k] / max(e, 1)
            resid = e * max(1.0 - cov, 0.0) ** 2
        t = _predict_cost_ns(n_nodes, e, resid * slot_factor, k, h, itemsize,
                             d_reads=d_reads, batch=batch, dense_split=dense_split,
                             edge_ns=edge_ns)
        if t < best_t:
            best_k, best_t = k, t
    return best_k


@dataclasses.dataclass
class HybridPlan:
    """Hot-set decomposition of a normalized adjacency (minus self-loops),
    as tensors on one device.

    hot_ids: int64 [K] node ids of the hot set, ascending.
    d_full:  [N, K] ``sum w(hot_k -> n)``: f32, bf16, or, when ``d_lo`` is
             set, the hi half of the bf16 (hi, lo) pair.
    d_lo:    the lo half under the f32 'split2' mode, else None.
    a_hh:    [K, K] hot-hot block ``D[hot_ids]`` (f32 hi + lo under the split).
    res:     CSR kernel plans of the cold-cold residual (None when it is
             empty or runs on the segment path).
    seg_src/seg_dst/seg_w: the residual as COO for the segment path
             (``resid_mode='segment'``), else None.
    fused:   with f32 'highest', run the dense pair in the dual kernel
             instead of two ``torch.mm``.
    n_resid: residual (cold-cold) edge count.
    predicted_spmm_ns: the cost model's price of one application.
    floor_spmm_ns: its floor at the build's width (:func:`plan_floor_ns`).
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
    seg_src: Optional[torch.Tensor] = None
    seg_dst: Optional[torch.Tensor] = None
    seg_w: Optional[torch.Tensor] = None
    predicted_spmm_ns: float = 0.0
    floor_spmm_ns: float = 0.0


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
    h_hint: int = 128,
    batch: int = 1,
) -> Optional[HybridPlan]:
    """Host-side construction. ``hot_k``: the hot-set size (0 = off: returns
    None), or 'auto': :func:`choose_hot_k` at width ``h_hint`` for
    ``batch`` members applying the plan together (None when it picks 0,
    and, with a warning, when the adjacency is not weight-symmetric). An
    integer K is clamped to N and, from 128 up, rounded down to a multiple
    of 128. ``validate``: True = exact symmetry audit of the hot-touching
    edges, 'fast' = the randomized audit of all edges, False = none.
    ``fused`` (None = off): f32 'highest' runs the dense pair in the dual
    kernel. ``f32_mode`` (None = 'split2'): 'split2' stores D as a bf16
    (hi, lo) pair for the split dual kernel; 'highest' keeps f32 D.
    ``resid_mode``: the cold-cold residual on the CSR kernel ('pallas'), on
    the segment path ('segment'), or on the one the model prices lower
    ('auto')."""
    if resid_mode not in RESID_MODES:
        raise ValueError(f"resid_mode must be one of {RESID_MODES}, got {resid_mode!r}")
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    f32_mode = f32_mode or DEFAULT_F32_MODE
    if f32_mode not in F32_MODES:
        raise ValueError(f"f32_mode must be one of {F32_MODES}, got {f32_mode!r}")
    dense_split = compute_dtype == "float32" and f32_mode == "split2"
    itemsize = _COMPUTE_DTYPES[compute_dtype].itemsize
    # the dual kernels read D once for both products; bf16 always runs in
    # one (ops/spmm_hybrid), f32 'highest' only when fused
    d_reads = 1 if (fused or dense_split or itemsize == 2) else 2
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    w = np.asarray(w, np.float32)
    auto = hot_k == "auto"
    if auto:
        hot_k = choose_hot_k(src, n_nodes, h=h_hint, itemsize=itemsize, dst=dst,
                             d_reads=d_reads, batch=batch,
                             segment_resid=resid_mode == "segment",
                             dense_split=dense_split)
    if not hot_k:
        return None
    k = int(min(int(hot_k), n_nodes))
    if k >= 128:
        k = (k // 128) * 128
    k = max(1, k)
    device = torch.device(device)

    hot_ids = hot_set(src, n_nodes, k)
    hot_rank = np.full(n_nodes, -1, np.int64)
    hot_rank[hot_ids] = np.arange(k)
    src_hot = hot_rank[src] >= 0
    dst_hot = hot_rank[dst] >= 0
    try:
        if validate == "fast":
            check_weight_symmetric_fast(src, dst, w, n_nodes)
        elif validate:
            check_weight_symmetric(src, dst, w, sel=src_hot | dst_hot)
    except ValueError:
        if not auto:
            raise
        # under 'auto' a directed operator takes the sparse path, which is
        # exact for it; an explicit K raises
        warnings.warn("hybrid_k='auto': the adjacency is not weight-symmetric; "
                      "falling back to the pure sparse SpMM path", stacklevel=2)
        return None

    d_full, d_lo, a_hh = dense_blocks(src, dst, w, n_nodes, hot_ids, compute_dtype,
                                      dense_split, device)
    rsel = ~src_hot & ~dst_hot
    n_resid = int(rsel.sum())
    edge_ns = csr_edge_ns(h_hint)
    use_csr = resid_mode == "pallas" or (
        resid_mode == "auto" and _PAD_FACTOR * edge_ns < segment_edge_ns(h_hint))
    res = seg = None
    if n_resid and use_csr:
        res = build_plan_from_arrays(src[rsel], dst[rsel], w[rsel], n_nodes,
                                     compute_dtype=compute_dtype, device=device)
    elif n_resid:
        seg = segment_arrays(src[rsel], dst[rsel], w[rsel], device)
    resid_units = n_resid * (_PAD_FACTOR if use_csr else segment_edge_ns(h_hint) / edge_ns)
    predicted = _predict_cost_ns(n_nodes, len(src), resid_units, k, h_hint, itemsize,
                                 d_reads=d_reads, dense_split=dense_split, edge_ns=edge_ns)
    plan = HybridPlan(
        hot_ids=torch.as_tensor(hot_ids, device=device), d_full=d_full, d_lo=d_lo,
        a_hh=a_hh, res=res, n_nodes=n_nodes, k=k, compute_dtype=compute_dtype,
        fused=bool(fused), n_resid=n_resid, predicted_spmm_ns=float(predicted),
        **dict(zip(("seg_src", "seg_dst", "seg_w"), seg or (None, None, None))),
    )
    plan.floor_spmm_ns = plan_floor_ns(plan, h_hint)
    return plan


def hot_set(src, n_nodes: int, k: int) -> np.ndarray:
    """The ``k`` nodes of highest out-degree (ties to the lower id),
    ascending: the JAX package's hot set."""
    deg = np.bincount(np.asarray(src, np.int64), minlength=n_nodes)
    order = np.argsort(-deg, kind="stable")
    return np.sort(order[:k]).astype(np.int64)


def dense_blocks(src, dst, w, n_nodes: int, hot_ids: np.ndarray, compute_dtype: str,
                 dense_split: bool, device: torch.device):
    """``(d_full, d_lo, a_hh)`` of the hot set ``hot_ids``: D accumulated on
    the host for the CPU, on the card otherwise, then split into its bf16
    (hi, lo) pair (``dense_split``) or cast to ``compute_dtype``."""
    k = len(hot_ids)
    hot_rank = np.full(n_nodes, -1, np.int64)
    hot_rank[hot_ids] = np.arange(k)
    sel = hot_rank[src] >= 0
    if device.type == "cpu":
        d32 = torch.from_numpy(dense_block_host(dst[sel], hot_rank[src[sel]], w[sel],
                                                n_nodes, k))
    else:
        d32 = dense_block_device(dst[sel], hot_rank[src[sel]], w[sel], n_nodes, k, device)
    hot_t = torch.as_tensor(hot_ids, device=device)
    if dense_split:
        d_full, d_lo = split_bf16(d32)
        return d_full, d_lo, d_full[hot_t].float() + d_lo[hot_t].float()
    d_full = d32.to(_COMPUTE_DTYPES[compute_dtype])
    return d_full, None, d_full[hot_t]


def segment_arrays(src, dst, w, device: torch.device):
    """Edges as the segment path takes them: int64 ids, f32 weights."""
    put = lambda a, dt: torch.as_tensor(np.asarray(a), device=device).to(dt)
    return put(src, torch.int64), put(dst, torch.int64), put(w, torch.float32)


def segment_sum(src: torch.Tensor, dst: torch.Tensor, w: torch.Tensor, x: torch.Tensor,
                n_rows: int) -> torch.Tensor:
    """``out[dst_e] += w_e * x[src_e]`` by gather and ``index_add``, f32:
    the segment path (the JAX package's ``jax.ops.segment_sum``)."""
    contrib = w[:, None] * x[src].float()
    out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add(0, dst, contrib)


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
    if plan.seg_src is not None:
        out = out + segment_sum(plan.seg_src, plan.seg_dst, plan.seg_w, x, plan.n_nodes)
    return out
