"""Sharded hybrid SpMM: each rank's dense hot block, the cold residual on
the halo exchange.

Port of ``pytextgcn_tpu/parallel/hybrid_sharded.py``. Activations stay
row-sharded as on the halo path (:mod:`.halo`): rank ``r`` holds rows
``[r * rows_per, (r+1) * rows_per)``. The hybrid decomposition
(ops/hybrid.py) is split by output rows:

* rank ``r`` holds ``D_r = D[r*rows_per:(r+1)*rows_per]`` ``[rows_per, K]``
  (``D[n, k] = sum w(hot_k -> n)``); its ``D_r @ x_hot`` needs only the
  replicated ``[K, H]`` hot activations;
* ``x_hot`` comes from one ``all_gather`` in which each rank sends its own
  hot rows, padded to the largest per-rank count ``k_max``;
* the hot-destination term ``D^T @ x`` sums over every rank: each computes
  ``D_r^T @ x_r`` and one ``all_reduce`` adds them (less ``A_hh @ x_hot``,
  the hot-hot block counted twice), and each rank scatters the result into
  its own hot rows;
* the cold-cold residual and the self-loop diagonal go through the halo
  exchange (:func:`.halo.build_halo_core` over the cold-cold edges, on the
  CSR kernel with ``use_pallas``).

With ``fused`` the rank's dense pair ``(D_r @ x_hot, D_r^T @ x_r)`` is one
call of the dual kernel (ops/fused_dual.py, reading D_r once): the TF32x3
kernel for f32 D, the bf16 kernel for bf16 D. Without it the pair is two
``torch.matmul`` on f32 operands (bf16 values are exact in f32, so a bf16
product keeps its f32 result, as JAX's ``preferred_element_type`` does).
There is no split2 mode: the JAX products here are f32 HIGHEST.

Unlike the JAX package, D_r is not padded to a row block: the dual kernel
has none. The backward is written out (:class:`HybridDenseFunction`): the
gathered hot rows are read by every rank, so the cotangent of ``x_hot`` is
summed over the ranks (one ``all_reduce``) and each rank takes its own
rows; the reduced partial is read by each rank at its own hot ranks only,
so its cotangent is an ``all_reduce`` of the ranks' cotangents. The local
math is apart from the collectives, so one process can run it for every
rank (the tests do).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..core.graph import TextGraph, gcn_normalize_np
from ..ops.fused_dual import fused_dual
from ..ops.hybrid import (check_weight_symmetric, check_weight_symmetric_fast, choose_hot_k,
                          dense_block_device, dense_block_host)
from ..ops.spmm_cuda import _COMPUTE_DTYPES
from .halo import HaloAdj, build_halo_core, spmm_halo
from .sharded import (Mesh, RowSharded, all_gather_rows, all_reduce_sum, put_global,
                      replicate_global)


@dataclasses.dataclass
class HybridShardedAdj(RowSharded):
    """This rank's part of the row-partitioned hot/cold decomposition.
    Every array equals index ``rank`` of the JAX package's ``[D, ...]`` one
    (``d_blk`` without the JAX row padding of its fused kernel).

    d_blk:      [rows_per, K] this rank's rows of D (compute dtype).
    hot_rows:   int32 [k_max] local rows of the hot nodes this rank owns
                (padded with rows_per: clipped on the gather, dropped on the
                scatter).
    hot_ranks:  int32 [k_max] the hot rank of each of those nodes (0 on
                padding, whose scatter is dropped).
    a_hh:       [K, K] the hot-hot block, replicated (compute dtype).
    hot_unpack: int32 [K] position of hot rank k in the ``D * k_max``-row
                all_gather buffer, replicated.
    halo_res:   HaloAdj over the cold-cold edges with the true self-loop
                diagonal.
    wire_rows:  rows this rank's collectives have moved in forward passes,
                counted as :attr:`comm_rows_per_device` prices them (the
                residual's in ``halo_res.wire_rows``).
    """

    d_blk: torch.Tensor
    hot_rows: torch.Tensor
    hot_ranks: torch.Tensor
    a_hh: torch.Tensor
    hot_unpack: torch.Tensor
    halo_res: HaloAdj
    n_nodes: int
    rows_per: int
    k: int
    k_max: int
    mesh: Mesh
    axis: str
    compute_dtype: str = "float32"
    fused: bool = False
    wire_rows: int = 0

    @property
    def comm_rows_per_device(self) -> int:
        """Rows on the wire per SpMM per rank, with the JAX package's ring
        accounting: the hot all_gather moves ``(D-1) * k_max`` rows, the
        all_reduce of the ``[K, H]`` partial ``2 K (D-1) / D``, the residual
        halo its boundary rows."""
        d = self.n_shards
        return ring_gather_rows(d, self.k_max) + ring_reduce_rows(d, self.k) + \
            self.halo_res.comm_rows_per_device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_hybrid_sharded(self, x)


def ring_gather_rows(world: int, rows: int) -> int:
    """Rows each rank moves in a ring all_gather of ``rows`` rows a rank."""
    return (world - 1) * rows


def ring_reduce_rows(world: int, rows: int) -> int:
    """Rows each rank moves in a ring all_reduce (reduce-scatter, then
    all_gather) of ``rows`` rows."""
    return 2 * rows * (world - 1) // world


def hot_layout(hot_ids: np.ndarray, rows_per: int, d: int):
    """Per-rank hot ownership (``hot_ids`` ascending, so each rank's hot
    nodes are one run): ``(k_max, hot_rows [d, k_max], hot_ranks [d,
    k_max], hot_unpack [K])`` as the JAX package lays them out."""
    k = len(hot_ids)
    counts = np.bincount(hot_ids // rows_per, minlength=d)
    k_max = max(1, int(counts.max()))
    hot_rows = np.full((d, k_max), rows_per, np.int32)  # pad -> dropped row
    hot_ranks = np.zeros((d, k_max), np.int32)
    hot_unpack = np.zeros(k, np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for dev in range(d):
        lo, hi = starts[dev], starts[dev + 1]
        m = hi - lo
        hot_rows[dev, :m] = hot_ids[lo:hi] - dev * rows_per
        hot_ranks[dev, :m] = np.arange(lo, hi)
        hot_unpack[lo:hi] = dev * k_max + np.arange(m)
    return k_max, hot_rows, hot_ranks, hot_unpack


def dense_rows(mesh: Mesh, dst_local, cols, w, n_rows: int, k: int) -> torch.Tensor:
    """A ``[n_rows, K]`` f32 block ``B[dst_local_e, cols_e] += w_e`` on the
    rank's device: accumulated on the host for the CPU, on the card
    otherwise (only the edges are shipped)."""
    if mesh.device.type == "cpu":
        return torch.from_numpy(dense_block_host(dst_local, cols, w, n_rows, k))
    return dense_block_device(dst_local, cols, w, n_rows, k, mesh.device)


def build_hybrid_sharded_adj(
    g: TextGraph,
    mesh: Mesh,
    axis: str = "graph",
    hot_k: Union[int, str] = "auto",
    compute_dtype: str = "float32",
    h_hint: int = 128,
    fused: Optional[bool] = None,
    use_pallas: bool = True,
) -> Optional[HybridShardedAdj]:
    """Host-side build of this rank's part. ``hot_k``: an integer K (0 or
    None: no hot set) or 'auto' (ops/hybrid.py's H100 ``choose_hot_k`` at
    width ``h_hint``, reading D once with ``fused``, twice without).
    Returns None when there is no hot set: the caller falls back to the
    pure halo path. The hot-destination term needs a weight-symmetric
    adjacency: under 'auto' an asymmetric one warns and returns None, a
    forced K raises. ``fused`` (None = off): the dense pair on the dual
    kernel. ``use_pallas``: the residual on CSR plans."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    d = mesh.world_size
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    norm_w, self_w = gcn_normalize_np(src, dst, np.asarray(g.edge_w), g.n_nodes)
    n_nodes = g.n_nodes
    fused = bool(fused)
    auto = hot_k == "auto"
    if auto:
        hot_k = choose_hot_k(src, n_nodes, h=h_hint,
                             itemsize=_COMPUTE_DTYPES[compute_dtype].itemsize, dst=dst,
                             d_reads=1 if fused else 2)
    if not hot_k:  # 0 / None: no hot set -> the pure halo path
        return None
    k = int(min(int(hot_k), n_nodes))
    if k >= 128:
        k = (k // 128) * 128
    k = max(1, k)

    deg = np.bincount(src, minlength=n_nodes)
    order = np.argsort(-deg, kind="stable")
    hot_ids = np.sort(order[:k]).astype(np.int64)
    hot_rank = np.full(n_nodes, -1, np.int64)
    hot_rank[hot_ids] = np.arange(k)
    src_hot = hot_rank[src] >= 0
    dst_hot = hot_rank[dst] >= 0
    try:
        if getattr(g, "weight_symmetric", False):
            check_weight_symmetric_fast(src, dst, norm_w, n_nodes)
        else:
            check_weight_symmetric(src, dst, norm_w, sel=src_hot | dst_hot)
    except ValueError:
        if auto:
            warnings.warn("hybrid_k='auto': the adjacency is not weight-symmetric; "
                          "falling back to the pure halo-exchange path", stacklevel=2)
            return None
        raise

    rows_per = -(-n_nodes // d)  # build_halo_core's partition
    r = mesh.rank
    cd = _COMPUTE_DTYPES[compute_dtype]
    # this rank's rows of D, and the hot-hot block (D's rows at the hot ids)
    mine = src_hot & (dst // rows_per == r)
    d_blk = dense_rows(mesh, dst[mine] - r * rows_per, hot_rank[src[mine]], norm_w[mine],
                       rows_per, k).to(cd)
    hh = src_hot & dst_hot
    a_hh = dense_rows(mesh, hot_rank[dst[hh]], hot_rank[src[hh]], norm_w[hh], k, k).to(cd)

    k_max, hot_rows, hot_ranks, hot_unpack = hot_layout(hot_ids, rows_per, d)
    rsel = ~src_hot & ~dst_hot
    halo_res = build_halo_core(src[rsel], dst[rsel], norm_w[rsel], self_w, n_nodes, mesh, axis,
                               use_pallas=use_pallas, compute_dtype=compute_dtype)
    return HybridShardedAdj(
        d_blk=d_blk,
        hot_rows=put_global(mesh, hot_rows)[0],
        hot_ranks=put_global(mesh, hot_ranks)[0],
        a_hh=a_hh,
        hot_unpack=replicate_global(mesh, hot_unpack),
        halo_res=halo_res,
        n_nodes=n_nodes,
        rows_per=rows_per,
        k=k,
        k_max=k_max,
        mesh=mesh,
        axis=axis,
        compute_dtype=compute_dtype,
        fused=fused,
    )


# ------------------------------------------------------------ local math


def hot_send_block(hot_rows: torch.Tensor, xc: torch.Tensor) -> torch.Tensor:
    """The ``[k_max, H]`` block of this rank's hot rows it sends to the
    all_gather (padding reads the last row; no rank unpacks it)."""
    return xc.index_select(0, hot_rows.long().clamp(max=xc.shape[0] - 1))


def unpack_hot(hot_unpack: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """``x_hot`` ``[K, H]`` from the ``[D * k_max, H]`` all_gather buffer."""
    return gathered.index_select(0, hot_unpack.long())


def scatter_rows(rows: torch.Tensor, vals: torch.Tensor, n_rows: int) -> torch.Tensor:
    """``out[rows_i] += vals_i`` into ``[n_rows, H]`` f32; an index of
    ``n_rows`` (padding) is dropped."""
    ext = torch.zeros(n_rows + 1, vals.shape[1], dtype=torch.float32, device=vals.device)
    return ext.index_add_(0, rows.long(), vals.float())[:n_rows]


def dense_pair(adj: HybridShardedAdj, xc: torch.Tensor,
               x_hot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's ``(D_r @ x_hot, D_r^T @ x_r)`` f32 (the second is its part
    of the sum over ranks): the dual kernel with ``fused``, else two f32
    ``torch.matmul``. Also the backward's pair, with ``(g_r, g_hot)`` in
    place of ``(x_r, x_hot)``."""
    if adj.fused:
        return fused_dual(adj.d_blk, xc, x_hot)
    d = adj.d_blk.float()
    return d @ x_hot.float(), d.t() @ xc.float()


def hybrid_dense_finish(adj: HybridShardedAdj, out: torch.Tensor, part_sum: torch.Tensor,
                        x_hot: torch.Tensor) -> torch.Tensor:
    """``out`` plus, at this rank's hot rows, ``sum_r D_r^T x_r - A_hh
    x_hot`` (``part_sum``: the ranks' parts summed)."""
    hot_in = part_sum - adj.a_hh.float() @ x_hot.float()
    return out + scatter_rows(adj.hot_rows, hot_in.index_select(0, adj.hot_ranks.long()),
                              adj.rows_per)


def hybrid_hot_cotangent(adj: HybridShardedAdj, g: torch.Tensor) -> torch.Tensor:
    """This rank's part ``[K, H]`` of the cotangent of the reduced partial:
    the gradient rows of its hot nodes at their hot ranks."""
    g_ext = torch.cat([g.float(), g.new_zeros((1, g.shape[1]), dtype=torch.float32)])
    out = torch.zeros(adj.k, g.shape[1], dtype=torch.float32, device=g.device)
    return out.index_add_(0, adj.hot_ranks.long(), g_ext.index_select(0, adj.hot_rows.long()))


def hybrid_dense_cotangents(adj: HybridShardedAdj, g: torch.Tensor,
                            g_hot: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """From this rank's output gradient ``g`` and the summed hot cotangent
    ``g_hot``: ``(D_r @ g_hot, D_r^T @ g)``, the first this rank's part of
    the cotangent of x_r, the second its part of that of ``x_hot``."""
    cd = _COMPUTE_DTYPES[adj.compute_dtype]
    return dense_pair(adj, g.to(cd), g_hot.to(cd))


def hybrid_finish_cotangent(adj: HybridShardedAdj, gx: torch.Tensor, g_xhot_sum: torch.Tensor,
                            g_hot: torch.Tensor) -> torch.Tensor:
    """The cotangent of x_r: ``gx`` plus this rank's rows of the cotangent
    of ``x_hot`` (``g_xhot_sum``: the ranks' parts summed, less ``A_hh^T
    g_hot``) scattered back through the all_gather and this rank's hot
    rows."""
    g_xhot = g_xhot_sum - adj.a_hh.float().t() @ g_hot
    buf = torch.zeros(adj.n_shards * adj.k_max, gx.shape[1], dtype=torch.float32,
                      device=gx.device)
    buf.index_copy_(0, adj.hot_unpack.long(), g_xhot)
    lo = adj.mesh.rank * adj.k_max
    return gx + scatter_rows(adj.hot_rows, buf[lo:lo + adj.k_max], adj.rows_per)


# ------------------------------------------------------------ collectives


class HybridDenseFunction(torch.autograd.Function):
    """The dense half of the sharded hybrid for row-sharded x ``[rows_per,
    H]``: the hot all_gather, the rank's dense pair, the all_reduce of the
    partial and the scatter into its hot rows. Backward: an all_reduce of
    the hot cotangent, the dense pair on ``(g, g_hot)``, an all_reduce of the
    ``x_hot`` cotangent, this rank's rows of it."""

    @staticmethod
    def forward(ctx, x_own: torch.Tensor, adj: HybridShardedAdj) -> torch.Tensor:
        ctx.adj, ctx.x_dtype = adj, x_own.dtype
        mesh, d = adj.mesh, adj.n_shards
        xc = x_own.to(_COMPUTE_DTYPES[adj.compute_dtype])
        x_hot = unpack_hot(adj.hot_unpack, all_gather_rows(mesh, hot_send_block(adj.hot_rows,
                                                                                xc)))
        out, part = dense_pair(adj, xc, x_hot)
        part_sum = all_reduce_sum(mesh, part.contiguous())
        adj.wire_rows += ring_gather_rows(d, adj.k_max) + ring_reduce_rows(d, adj.k)
        return hybrid_dense_finish(adj, out, part_sum, x_hot)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        adj = ctx.adj
        g_hot = all_reduce_sum(adj.mesh, hybrid_hot_cotangent(adj, g))
        gx, g_xhot = hybrid_dense_cotangents(adj, g, g_hot)
        g_xhot = all_reduce_sum(adj.mesh, g_xhot.contiguous())
        return hybrid_finish_cotangent(adj, gx, g_xhot, g_hot).to(ctx.x_dtype), None


def spmm_hybrid_sharded(adj: HybridShardedAdj, x: torch.Tensor) -> torch.Tensor:
    """``A_hat @ x`` with row-sharded activations: ``x`` is this rank's rows
    ``[rows_per, H]``; returns its rows of the result, f32. The residual
    and the self term run in the operator's compute dtype, as the dense
    half does."""
    if x.shape[0] != adj.rows_per:
        raise ValueError(f"spmm_hybrid_sharded takes this rank's {adj.rows_per} rows, "
                         f"got {x.shape[0]}")
    return HybridDenseFunction.apply(x, adj) + spmm_halo(adj.halo_res, x)
