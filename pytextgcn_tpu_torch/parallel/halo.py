"""Halo-exchange edge-partitioned SpMM: boundary rows only, no replication.

Port of ``pytextgcn_tpu/parallel/halo.py``. Activations stay row-sharded
end to end: rank ``r`` holds rows ``[r*rows_per, (r+1)*rows_per)`` as a
``[rows_per, H]`` tensor (``n_pad = rows_per * D``; pad rows past N have no
edges and a zero self-loop weight).

* a host-built plan records, per (sender, step), exactly which of the
  sender's rows another shard needs: the *halo*;
* the ring: at step ``s`` rank ``r`` sends ``x_own[send_idx[s]]`` to
  ``(r+s+1) % D`` and receives from ``(r-s-1) % D``; every send and receive
  is posted (``dist.batch_isend_irecv``) before the own-block aggregation,
  as JAX issues its ``ppermute``s first;
* each received block feeds an aggregation into the shard's own rows;
* the backward is the reverse ring: the gradient of each received block
  goes back to its sender, which ``index_add_``s it into its ``send_idx``
  rows.

With CSR plans (``use_pallas``, the port's default) the own block and each
step's remote block run in ``spmm_csr``: plans ``[rows_per, rows_per]`` and
``[rows_per, s_max]``, their transposes for the backward. These are the
segment sums JAX computes with ``segment_sum``; the gather/``index_add_``
form is the path without plans and the oracle.

``compute_dtype='bfloat16'`` casts the sent rows (and, without plans, the
weights) and accumulates in f32, halving the bytes on the wire.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import TextGraph, gcn_normalize_np
from ..ops.spmm_cuda import _COMPUTE_DTYPES, SpmmPlan, spmm_csr
from .sharded import Mesh, RowSharded, put_global, rank_plan


@dataclasses.dataclass
class HaloAdj(RowSharded):
    """This rank's part of the row-partitioned adjacency with its halo plan.
    Every array equals index ``rank`` of the JAX package's ``[D, ...]`` one.

    own_*:    [E_own] edges whose src AND dst live on the shard (local rows;
              w=0 padding); ``n_own`` of them are real.
    send_idx: [D-1, S] local rows this rank sends at step s (to rank
              (r+s+1) mod D; 0-padded: no edge reads a padded row).
    rem_pos:  [D-1, E_rem] row of each remote-source edge in the block
              received at step s; ``n_rem[s]`` of them are real.
    rem_dst/rem_w: [D-1, E_rem] local destination and weight (w=0 pad).
    self_w:   [rows_per] this rank's self-loop diagonal (0 on pad rows).
    plan_own / plan_rem: the CSR kernel's plans of the own block and of
              each step's remote block (forward and transpose), or None.
    wire_rows: rows this rank has sent in forward passes.
    """

    own_src: torch.Tensor
    own_dst: torch.Tensor
    own_w: torch.Tensor
    send_idx: torch.Tensor
    rem_pos: torch.Tensor
    rem_dst: torch.Tensor
    rem_w: torch.Tensor
    self_w: torch.Tensor
    n_nodes: int
    rows_per: int
    mesh: Mesh
    axis: str
    n_own: int
    n_rem: Tuple[int, ...]
    plan_own: Optional[SpmmPlan] = None
    plan_rem: Optional[List[SpmmPlan]] = None
    compute_dtype: str = "float32"
    wire_rows: int = 0

    @property
    def comm_rows_per_device(self) -> int:
        """Halo rows each rank sends per SpMM (plan size S per step)."""
        return int(self.send_idx.shape[0] * self.send_idx.shape[1])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_halo(self, x)


def build_halo_adj(g: TextGraph, mesh: Mesh, axis: str = "graph", use_pallas: bool = False,
                   compute_dtype: str = "float32") -> HaloAdj:
    """Host-side plan: partition rows, split edges into own/remote-by-step,
    compute per-(sender, step) unique halo row lists."""
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    norm_w, self_w = gcn_normalize_np(src, dst, np.asarray(g.edge_w), g.n_nodes)
    return build_halo_core(src, dst, norm_w, self_w, g.n_nodes, mesh, axis,
                           use_pallas=use_pallas, compute_dtype=compute_dtype)


def build_halo_core(src: np.ndarray, dst: np.ndarray, norm_w: np.ndarray, self_w: np.ndarray,
                    n_nodes: int, mesh: Mesh, axis: str = "graph", use_pallas: bool = False,
                    compute_dtype: str = "float32") -> HaloAdj:
    """Halo plan over an already-normalized edge list, with the padding
    rules of the JAX package (``e_own``, ``s_max``, ``e_rem``) exactly: they
    take every shard's lists, which each rank computes alike."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    src = np.asarray(src, np.int64)
    dst = np.asarray(dst, np.int64)
    d = mesh.world_size

    rows_per = -(-n_nodes // d)
    n_pad = rows_per * d
    dst_shard = dst // rows_per
    src_shard = src // rows_per

    own_lists, rem_lists = [], []
    for dev in range(d):
        mine = dst_shard == dev
        own_m = mine & (src_shard == dev)
        own_lists.append(
            (src[own_m] - dev * rows_per, dst[own_m] - dev * rows_per, norm_w[own_m]))
        rem_steps = []
        for s in range(1, d):
            peer = (dev - s) % d  # the block received at step s-1 comes from here
            m = mine & (src_shard == peer)
            uniq = np.unique(src[m]) - peer * rows_per  # sorted local rows
            pos = np.searchsorted(uniq, src[m] - peer * rows_per)
            rem_steps.append((uniq, pos, dst[m] - dev * rows_per, norm_w[m]))
        rem_lists.append(rem_steps)

    e_own = max(1, max(len(t[2]) for t in own_lists))
    s_max, e_rem = 1, 1
    for dev in range(d):
        for uniq, _, _, wl in rem_lists[dev]:
            s_max = max(s_max, len(uniq))
            e_rem = max(e_rem, len(wl))

    own_src = np.zeros((d, e_own), np.int32)
    own_dst = np.zeros((d, e_own), np.int32)
    own_w = np.zeros((d, e_own), np.float32)
    for dev, (s_, d_, w_) in enumerate(own_lists):
        own_src[dev, :len(w_)] = s_
        own_dst[dev, :len(w_)] = d_
        own_w[dev, :len(w_)] = w_

    n_steps = max(d - 1, 1)
    send_idx = np.zeros((d, n_steps, s_max), np.int32)
    rem_pos = np.zeros((d, n_steps, e_rem), np.int32)
    rem_dst = np.zeros((d, n_steps, e_rem), np.int32)
    rem_w = np.zeros((d, n_steps, e_rem), np.float32)
    for dev in range(d):
        for s, (uniq, pos, dl, wl) in enumerate(rem_lists[dev]):
            # ring step s+1: dev receives this block from (dev - (s+1)) % d
            rem_pos[dev, s, :len(pos)] = pos
            rem_dst[dev, s, :len(dl)] = dl
            rem_w[dev, s, :len(wl)] = wl
            send_idx[(dev - (s + 1)) % d, s, :len(uniq)] = uniq

    self_pad = np.zeros(n_pad, np.float32)
    self_pad[:n_nodes] = self_w

    r = mesh.rank
    n_own = len(own_lists[r][2])
    n_rem = tuple(len(t[3]) for t in rem_lists[r])
    plan_own = plan_rem = None
    if use_pallas:
        def plans(rows, cols, w, n_rows, n_cols):
            return SpmmPlan(fwd=rank_plan(mesh, rows, cols, w, n_rows, n_cols),
                            bwd=rank_plan(mesh, cols, rows, w, n_cols, n_rows),
                            compute_dtype=compute_dtype)

        plan_own = plans(own_dst[r, :n_own], own_src[r, :n_own], own_w[r, :n_own],
                         rows_per, rows_per)
        plan_rem = [plans(rem_dst[r, s, :k], rem_pos[r, s, :k], rem_w[r, s, :k],
                          rows_per, s_max) for s, k in enumerate(n_rem)]

    return HaloAdj(
        own_src=put_global(mesh, own_src)[0],
        own_dst=put_global(mesh, own_dst)[0],
        own_w=put_global(mesh, own_w)[0],
        send_idx=put_global(mesh, send_idx)[0],
        rem_pos=put_global(mesh, rem_pos)[0],
        rem_dst=put_global(mesh, rem_dst)[0],
        rem_w=put_global(mesh, rem_w)[0],
        self_w=put_global(mesh, self_pad.reshape(d, rows_per))[0],
        n_nodes=n_nodes,
        rows_per=rows_per,
        mesh=mesh,
        axis=axis,
        n_own=n_own,
        n_rem=n_rem,
        plan_own=plan_own,
        plan_rem=plan_rem,
        compute_dtype=compute_dtype,
    )


# ------------------------------------------------------------ local math


def _gather_sum(rows, cols, w, x, n_rows: int, cd: torch.dtype) -> torch.Tensor:
    """``out[rows_e] += w_e * x[cols_e]``: operands in ``cd``, f32 sums."""
    contrib = (w.to(cd)[:, None] * x.to(cd).index_select(0, cols.long())).float()
    out = torch.zeros(n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    return out.index_add_(0, rows.long(), contrib)


def halo_send_blocks(adj: HaloAdj, x_own: torch.Tensor) -> List[torch.Tensor]:
    """The ``[S, H]`` block this rank sends at each ring step."""
    return [x_own.index_select(0, adj.send_idx[s].long()) for s in range(adj.n_shards - 1)]


def halo_own_rows(adj: HaloAdj, x_own: torch.Tensor, cd: torch.dtype) -> torch.Tensor:
    """The own block's aggregation into this rank's rows, f32."""
    if adj.plan_own is not None:
        return spmm_csr(adj.plan_own.fwd, x_own.to(cd).contiguous())
    k = adj.n_own
    return _gather_sum(adj.own_dst[:k], adj.own_src[:k], adj.own_w[:k], x_own, adj.rows_per, cd)


def halo_remote_rows(adj: HaloAdj, recvs: List[torch.Tensor], cd: torch.dtype) -> torch.Tensor:
    """Each received block's aggregation into this rank's rows, summed, f32."""
    out = None
    for s, blk in enumerate(recvs):
        if adj.plan_rem is not None:
            part = spmm_csr(adj.plan_rem[s].fwd, blk.to(cd).contiguous())
        else:
            k = adj.n_rem[s]
            part = _gather_sum(adj.rem_dst[s, :k], adj.rem_pos[s, :k], adj.rem_w[s, :k], blk,
                               adj.rows_per, cd)
        out = part if out is None else out + part
    return out


def halo_local_rows(adj: HaloAdj, x_own: torch.Tensor, recvs: List[torch.Tensor],
                    cd: torch.dtype = torch.float32) -> torch.Tensor:
    """``(A - diag) @ x`` at this rank's rows from its own rows and the
    blocks it received (one per ring step), f32."""
    out = halo_own_rows(adj, x_own, cd)
    return out if not recvs else out + halo_remote_rows(adj, recvs, cd)


def halo_local_cotangents(adj: HaloAdj, g: torch.Tensor, cd: torch.dtype = torch.float32):
    """From the gradient ``g`` of this rank's output rows: the cotangent of
    its own rows through the own block ``[rows_per, H]``, and of each
    received block ``[S, H]`` (to be returned to its sender), f32."""
    gc = g.to(cd).contiguous()
    if adj.plan_own is not None:
        g_own = spmm_csr(adj.plan_own.bwd, gc)
        g_recv = [spmm_csr(p.bwd, gc) for p in adj.plan_rem[:adj.n_shards - 1]]
        return g_own, g_recv
    s_max = adj.send_idx.shape[1]
    k = adj.n_own
    g_own = _gather_sum(adj.own_src[:k], adj.own_dst[:k], adj.own_w[:k], gc, adj.rows_per, cd)
    g_recv = [_gather_sum(adj.rem_pos[s, :n], adj.rem_dst[s, :n], adj.rem_w[s, :n], gc, s_max,
                          cd) for s, n in enumerate(adj.n_rem)]
    return g_own, g_recv


def halo_scatter_returned(adj: HaloAdj, g_own: torch.Tensor,
                          returned: List[torch.Tensor]) -> torch.Tensor:
    """Add the cotangents returned for each sent block into the rows they
    came from (``send_idx``); returns ``g_own``, added to in place."""
    for s, blk in enumerate(returned):
        g_own.index_add_(0, adj.send_idx[s].long(), blk.float())
    return g_own


# ------------------------------------------------------------ the ring


class _Ring:
    """One ring exchange in flight: every send and receive posted at once;
    :meth:`wait` gives the received blocks on the rank's device."""

    def __init__(self, mesh: Mesh, blocks: List[torch.Tensor], reverse: bool):
        d, r = mesh.world_size, mesh.rank
        self.device = mesh.device
        self.recvs, ops = [], []
        for s, blk in enumerate(blocks):
            to, frm = (r + s + 1) % d, (r - s - 1) % d
            if reverse:
                to, frm = frm, to
            # gloo sends and receives CPU tensors only: ranks sharing one
            # card over gloo stage each block through host memory
            send = blk.cpu() if mesh.staged else blk.contiguous()
            recv = torch.empty_like(send)
            ops.append(dist.P2POp(dist.isend, send, mesh.global_rank(to), mesh.group, s))
            ops.append(dist.P2POp(dist.irecv, recv, mesh.global_rank(frm), mesh.group, s))
            self.recvs.append(recv)
        self.reqs = dist.batch_isend_irecv(ops) if ops else []

    def wait(self) -> List[torch.Tensor]:
        for req in self.reqs:
            req.wait()
        return [t.to(self.device) for t in self.recvs]


class HaloSpmmFunction(torch.autograd.Function):
    """``(A - diag) @ x`` for row-sharded x ``[rows_per, H]``: the ring,
    the own block while it is in flight, then the received blocks; the
    backward is the reverse ring."""

    @staticmethod
    def forward(ctx, x_own: torch.Tensor, adj: HaloAdj, cd: torch.dtype) -> torch.Tensor:
        ctx.adj, ctx.cd, ctx.x_dtype = adj, cd, x_own.dtype
        xc = x_own.to(cd)
        blocks = halo_send_blocks(adj, xc)
        adj.wire_rows += sum(b.shape[0] for b in blocks)
        ring = _Ring(adj.mesh, blocks, reverse=False)
        out = halo_own_rows(adj, xc, cd)
        recvs = ring.wait()
        return out if not recvs else out + halo_remote_rows(adj, recvs, cd)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        adj, cd = ctx.adj, ctx.cd
        g_own, g_recv = halo_local_cotangents(adj, g, cd)
        ring = _Ring(adj.mesh, [t.to(cd) for t in g_recv], reverse=True)
        return halo_scatter_returned(adj, g_own, ring.wait()).to(ctx.x_dtype), None, None


def spmm_halo(adj: HaloAdj, x: torch.Tensor, compute_dtype: Optional[str] = None) -> torch.Tensor:
    """``A_hat @ x`` with row-sharded activations and boundary-only exchange.

    ``x``: this rank's rows ``[rows_per, H]``; returns its rows of the
    result, f32. ``compute_dtype`` (default: the operator's, from the
    trainer's ``pallas_dtype``): the dtype of the sent rows and of the
    products' operands; accumulation stays f32."""
    if x.shape[0] != adj.rows_per:
        raise ValueError(f"spmm_halo takes this rank's {adj.rows_per} rows, got {x.shape[0]}")
    cd = _COMPUTE_DTYPES[compute_dtype or adj.compute_dtype]
    out = HaloSpmmFunction.apply(x, adj, cd)
    return out + (adj.self_w.to(cd)[:, None] * x.to(cd)).float()
