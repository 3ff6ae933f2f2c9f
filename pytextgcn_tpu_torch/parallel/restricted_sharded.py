"""Output-row-restricted sharded head: masked-head training over ranks.

Port of ``pytextgcn_tpu/parallel/restricted_sharded.py``. Single-device, the
masked head (ops/restricted.py) aggregates the final layer into the train
rows only, the rows the masked loss reads. Over ranks the head keeps the
row-sharded layout of the halo and the sharded hybrid:

* the output is this rank's full ``[rows_per, H]`` block, exactly zero at
  its non-train rows, so the trainer passes the ordinary labels and train
  mask: a zero row carries a zero cotangent and the gradients are exact;
* without a hot set the operator is a :class:`~.halo.HaloAdj` over the
  edges into train rows, with the self-loop diagonal masked to the train
  rows: the halo exchange does all the work;
* with a hot set, edges from the K hottest sources go through a dense
  ``[m_max, K]`` slab over the train rows this rank owns, against the same
  hot ``all_gather`` as the sharded hybrid (:mod:`.hybrid_sharded`), and
  the slab is scattered into the rank's rows. Destinations are train rows
  only, so there is no transposed term and no weight symmetry is needed;
  the src-cold residual goes through the halo exchange.

The slab's product is a plain f32 ``torch.matmul``, as the JAX package
leaves it to XLA. ``'auto'`` K is ops/restricted.py's H100
``choose_restricted_k`` over the restricted edges, not the JAX package's
TPU-priced chooser.

Under the 'allgather' partition activations are replicated; there
:class:`ReplicatedHead` takes this rank's rows in and gathers the head's
rows out, so every rank sees the whole ``[N, H]`` output as the loss needs
it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph, gcn_normalize_np
from ..ops.restricted import choose_restricted_k
from ..ops.spmm_cuda import _COMPUTE_DTYPES
from .halo import HaloAdj, build_halo_core, spmm_halo
from .hybrid_sharded import (dense_rows, hot_layout, hot_send_block, ring_gather_rows,
                             scatter_rows, unpack_hot)
from .sharded import (Mesh, RowSharded, all_gather_rows, all_reduce_sum, local_block,
                      put_global, replicate_global)


@dataclasses.dataclass
class RestrictedShardedAdj(RowSharded):
    """This rank's part of the train-row-restricted hot/cold decomposition.
    Every array equals index ``rank`` of the JAX package's ``[D, ...]`` one.

    d_blk:      [m_max, K] the src-hot block at this rank's train rows (zero
                rows on padding; compute dtype).
    out_rows:   int32 [m_max] local rows of those train rows (padded with
                rows_per: dropped on the scatter).
    hot_rows:   int32 [k_max] local rows of the hot nodes this rank owns
                (padded with rows_per).
    hot_unpack: int32 [K] position of hot rank k in the all_gather buffer.
    halo_res:   HaloAdj over the src-cold restricted edges with the self-loop
                diagonal masked to the train rows.
    """

    d_blk: torch.Tensor
    out_rows: torch.Tensor
    hot_rows: torch.Tensor
    hot_unpack: torch.Tensor
    halo_res: HaloAdj
    n_nodes: int
    rows_per: int
    k: int
    k_max: int
    m_max: int
    mesh: Mesh
    axis: str
    compute_dtype: str = "float32"

    @property
    def comm_rows_per_device(self) -> int:
        """Rows on the wire per restricted SpMM per rank: the hot all_gather
        (ring accounting) plus the residual halo; no reduced partial."""
        return ring_gather_rows(self.n_shards, self.k_max) + self.halo_res.comm_rows_per_device

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_restricted_sharded(self, x)


def build_restricted_sharded_adj(
    g: TextGraph,
    rows,
    mesh: Mesh,
    axis: str = "graph",
    hot_k: Optional[Union[int, str]] = None,
    compute_dtype: str = "float32",
    use_pallas: bool = True,
    h_hint: int = 128,
) -> Union[HaloAdj, RestrictedShardedAdj]:
    """Host-side build of this rank's part. ``rows``: sorted unique global
    node ids (the train rows). ``hot_k``: None or 0 for the pure halo head;
    'auto' for ``choose_restricted_k`` at width ``h_hint`` over the
    restricted edges; an integer forces K. Returns a plain HaloAdj when no
    hot set is used. ``use_pallas``: the halo parts on CSR plans."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    d = mesh.world_size
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    norm_w, self_w = gcn_normalize_np(src, dst, np.asarray(g.edge_w), g.n_nodes)
    n = g.n_nodes
    rows = np.asarray(rows, np.int64)
    m = int(rows.shape[0])

    in_rows = np.zeros(n, bool)
    in_rows[rows] = True
    sel = in_rows[dst]
    r_src, r_dst, r_w = src[sel], dst[sel], norm_w[sel]
    self_masked = np.where(in_rows, self_w, 0.0).astype(np.float32)
    halo = lambda s, t, w: build_halo_core(s, t, w, self_masked, n, mesh, axis,
                                           use_pallas=use_pallas, compute_dtype=compute_dtype)

    if hot_k == "auto":
        hot_k = choose_restricted_k(r_src, n, m, h=h_hint,
                                    itemsize=_COMPUTE_DTYPES[compute_dtype].itemsize)
    if not hot_k:
        return halo(r_src, r_dst, r_w)

    k = int(min(int(hot_k), n))
    if k >= 128:
        k = (k // 128) * 128
    k = max(1, k)
    deg = np.bincount(r_src, minlength=n)
    order = np.argsort(-deg, kind="stable")
    hot_ids = np.sort(order[:k]).astype(np.int64)
    hot_rank = np.full(n, -1, np.int64)
    hot_rank[hot_ids] = np.arange(k)
    hsel = hot_rank[r_src] >= 0

    rows_per = -(-n // d)  # build_halo_core's partition
    # each rank's train rows, compacted into its slab
    row_counts = np.bincount(rows // rows_per, minlength=d)
    m_max = max(1, int(row_counts.max()))
    out_rows = np.full((d, m_max), rows_per, np.int32)  # pad -> dropped row
    slot_of_node = np.full(n, -1, np.int64)
    starts = np.concatenate([[0], np.cumsum(row_counts)])
    for dev in range(d):
        lo, hi = starts[dev], starts[dev + 1]
        out_rows[dev, :hi - lo] = rows[lo:hi] - dev * rows_per
        slot_of_node[rows[lo:hi]] = np.arange(hi - lo)

    r = mesh.rank
    mine = hsel & (r_dst // rows_per == r)
    d_blk = dense_rows(mesh, slot_of_node[r_dst[mine]], hot_rank[r_src[mine]], r_w[mine],
                       m_max, k).to(_COMPUTE_DTYPES[compute_dtype])
    k_max, hot_rows, _, hot_unpack = hot_layout(hot_ids, rows_per, d)
    csel = ~hsel
    return RestrictedShardedAdj(
        d_blk=d_blk,
        out_rows=put_global(mesh, out_rows)[0],
        hot_rows=put_global(mesh, hot_rows)[0],
        hot_unpack=replicate_global(mesh, hot_unpack),
        halo_res=halo(r_src[csel], r_dst[csel], r_w[csel]),
        n_nodes=n,
        rows_per=rows_per,
        k=k,
        k_max=k_max,
        m_max=m_max,
        mesh=mesh,
        axis=axis,
        compute_dtype=compute_dtype,
    )


# ------------------------------------------------------------ local math


def restricted_slab(adj: RestrictedShardedAdj, x_hot: torch.Tensor) -> torch.Tensor:
    """``D_r @ x_hot`` scattered into this rank's train rows, f32."""
    slab = adj.d_blk.float() @ x_hot.float()
    return scatter_rows(adj.out_rows, slab, adj.rows_per)


def restricted_hot_cotangent(adj: RestrictedShardedAdj, g: torch.Tensor) -> torch.Tensor:
    """This rank's part ``[K, H]`` of the cotangent of ``x_hot``:
    ``D_r^T`` times the gradient at its train rows."""
    g_ext = torch.cat([g.float(), g.new_zeros((1, g.shape[1]), dtype=torch.float32)])
    return adj.d_blk.float().t() @ g_ext.index_select(0, adj.out_rows.long())


def restricted_finish_cotangent(adj: RestrictedShardedAdj,
                                g_xhot_sum: torch.Tensor) -> torch.Tensor:
    """The cotangent of x_r from the summed ``x_hot`` cotangent: this rank's
    rows of the all_gather buffer, scattered into its hot rows."""
    buf = torch.zeros(adj.n_shards * adj.k_max, g_xhot_sum.shape[1], dtype=torch.float32,
                      device=g_xhot_sum.device)
    buf.index_copy_(0, adj.hot_unpack.long(), g_xhot_sum)
    lo = adj.mesh.rank * adj.k_max
    return scatter_rows(adj.hot_rows, buf[lo:lo + adj.k_max], adj.rows_per)


class RestrictedDenseFunction(torch.autograd.Function):
    """The dense half of the restricted head for row-sharded x: the hot
    all_gather and the slab product; backward: the slab's transpose, one
    all_reduce, this rank's rows."""

    @staticmethod
    def forward(ctx, x_own: torch.Tensor, adj: RestrictedShardedAdj) -> torch.Tensor:
        ctx.adj, ctx.x_dtype = adj, x_own.dtype
        xc = x_own.to(_COMPUTE_DTYPES[adj.compute_dtype])
        x_hot = unpack_hot(adj.hot_unpack, all_gather_rows(adj.mesh, hot_send_block(
            adj.hot_rows, xc)))
        return restricted_slab(adj, x_hot)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        adj = ctx.adj
        g_xhot = all_reduce_sum(adj.mesh, restricted_hot_cotangent(adj, g).contiguous())
        return restricted_finish_cotangent(adj, g_xhot).to(ctx.x_dtype), None


def spmm_restricted_sharded(adj: RestrictedShardedAdj, x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of ``A_hat @ x`` at its train rows, zero elsewhere:
    ``x`` and the result are ``[rows_per, H]``, the result f32."""
    if x.shape[0] != adj.rows_per:
        raise ValueError(f"spmm_restricted_sharded takes this rank's {adj.rows_per} rows, "
                         f"got {x.shape[0]}")
    return RestrictedDenseFunction.apply(x, adj) + spmm_halo(adj.halo_res, x)


# ------------------------------------------------------------ replicated activations


@dataclasses.dataclass
class ReplicatedHead:
    """A row-sharded head (``op``: RestrictedShardedAdj or HaloAdj) applied
    to replicated ``[N, H]`` activations, the 'allgather' partition's: this
    rank's rows in, every rank's rows gathered out."""

    op: Union[HaloAdj, RestrictedShardedAdj]
    row_block = None  # activations are replicated

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        """The head on replicated ``x`` ``[N, H]``; the result ``[N, H]``,
        replicated (zero at non-train rows)."""
        x_own = RowBlockFunction.apply(x, self.op.mesh, self.op.rows_per)
        return GatherRowsFunction.apply(self.op.apply(x_own), self.op.mesh, self.op.n_nodes)


class RowBlockFunction(torch.autograd.Function):
    """This rank's rows of a replicated tensor; backward: every rank's rows
    of the cotangent gathered (each rank holds only its own)."""

    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, rows_per: int) -> torch.Tensor:
        ctx.mesh, ctx.n = mesh, t.shape[0]
        return local_block(mesh, t, rows_per)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_gather_rows(ctx.mesh, g.contiguous())[:ctx.n], None, None


class GatherRowsFunction(torch.autograd.Function):
    """Every rank's row block, concatenated; backward: this rank's rows of
    the replicated cotangent (every rank computes the same loss, so a sum
    over ranks would count it ``world`` times)."""

    @staticmethod
    def forward(ctx, local: torch.Tensor, mesh: Mesh, n: int) -> torch.Tensor:
        ctx.mesh, ctx.rows_per = mesh, local.shape[0]
        return all_gather_rows(mesh, local.contiguous())[:n]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return local_block(ctx.mesh, g, ctx.rows_per), None, None
