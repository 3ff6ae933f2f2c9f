"""Edge-partitioned SpMM over ranks of a ``torch.distributed`` group.

Port of ``pytextgcn_tpu/parallel/sharded.py``. JAX runs the mesh as one
program over global arrays (``shard_map``); here each rank is a process
holding its own tensors, and the collectives are written out:

* the adjacency is row-partitioned: rank ``r`` owns output rows
  ``[r * rows_per, (r+1) * rows_per)`` and every edge whose destination
  falls there (a host-side partition every rank computes alike);
* node features and activations are replicated: each rank aggregates its
  row block with ``spmm_csr`` on a forward plan ``[rows_per, N]``, then an
  ``all_gather`` reassembles the full ``[N, H]`` activation, so everything
  after it (dense layers, loss, metrics) runs identically on every rank;
* the gather's backward keeps this rank's rows of the replicated output
  gradient (not a reduce-scatter: a sum over ranks would count the gradient
  ``world`` times), the kernel runs on the transpose plan ``[N, rows_per]``
  and the partial cotangents of x are summed with ``all_reduce``, as
  ``shard_map`` psums them. Parameter gradients then come out identical on
  every rank and are not reduced again.

The ``ROW_BLOCK`` alignment of the JAX Pallas path is a TPU tile constant;
the CSR kernel has no row block, so ``rows_per = ceil(N / D)`` always, and
the arrays equal JAX's ``build_sharded_adj(..., use_pallas=False)`` ones.
The local math (:func:`sharded_local_rows`, :func:`sharded_local_cotangent`)
is apart from the collectives, so one process can run it for every rank.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from ..core.graph import TextGraph, gcn_normalize_np
from ..ops.hybrid import segment_sum
from ..ops.spmm_cuda import _COMPUTE_DTYPES, CsrPlan, build_csr_plan, spmm_csr
from ..utils import resolve_device


@dataclasses.dataclass
class Mesh:
    """The ranks one sharded operator spans: ``group`` (None only where one
    process plays every rank, as the tests do), this process's ``rank`` in
    it and its ``device``. ``ranks`` maps a mesh rank to its global rank
    (the peer point-to-point operations address)."""

    group: Optional[object]
    rank: int
    world_size: int
    device: torch.device
    backend: Optional[str] = None
    axis: str = "graph"
    ranks: Optional[Tuple[int, ...]] = None

    def global_rank(self, r: int) -> int:
        return r if self.ranks is None else self.ranks[r]

    @property
    def staged(self) -> bool:
        """Point-to-point blocks go through host memory: gloo's send and
        recv take CPU tensors only, so ranks that share one card over gloo
        copy each block to the host and back (their all_gather and
        all_reduce take CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"


def _rank_device(device, backend: str, rank: int) -> torch.device:
    """This rank's device. NCCL: card ``LOCAL_RANK`` (or ``rank``), and a
    rank beyond the visible cards is refused, since NCCL refuses two ranks
    on one GPU. gloo with a CUDA device: the card asked for, shared."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if backend == "nccl":
        idx = int(os.environ.get("LOCAL_RANK", rank))
        if idx >= torch.cuda.device_count():
            raise RuntimeError(
                f"rank {rank} needs card {idx}, and {torch.cuda.device_count()} are visible: "
                "NCCL refuses two ranks on one GPU. Start at most one rank a card, or ask "
                "for ranks sharing a card with backend='gloo'")
        dev = torch.device("cuda", idx)
    elif dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.set_device(dev)
    return dev


def make_mesh(n_devices: Optional[int] = None, axis: str = "graph",
              device: Optional[Union[str, torch.device]] = None,
              backend: Optional[str] = None) -> Mesh:
    """A mesh over every rank of the default group, which it joins (a group
    of one without a cluster environment) if this process has not yet
    (:func:`..multihost.init_distributed`). ``n_devices``: None or 0 for the
    whole group, else it must equal the group's size: a rank is a device.
    ``device``: None means the GPU (raises without one)."""
    from .multihost import init_distributed

    if not dist.is_initialized():
        init_distributed(backend=backend, device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices and n_devices != world:
        raise ValueError(
            f"a mesh of {n_devices} devices needs a group of {n_devices} ranks, this one has "
            f"{world}: start them with torchrun or the flat experiment's --train-n-devices")
    be = dist.get_backend()
    return Mesh(group=dist.group.WORLD, rank=rank, world_size=world,
                device=_rank_device(device, be, rank), backend=be, axis=axis,
                ranks=tuple(range(world)))


def put_global(mesh: Mesh, arr) -> torch.Tensor:
    """This rank's row block of a host array every rank holds whole (graph
    finalization is deterministic), on the rank's device: rows
    ``[r * b, (r+1) * b)`` with ``b = len(arr) / world_size``. A stacked
    ``[D, ...]`` array gives its ``[1, ...]`` entry."""
    arr = np.asarray(arr)
    if arr.shape[0] % mesh.world_size:
        raise ValueError(f"{arr.shape[0]} rows do not split over {mesh.world_size} ranks")
    b = arr.shape[0] // mesh.world_size
    return torch.as_tensor(np.ascontiguousarray(arr[mesh.rank * b:(mesh.rank + 1) * b]),
                           device=mesh.device)


def replicate_global(mesh: Mesh, arr) -> torch.Tensor:
    """The whole array on this rank's device."""
    return torch.as_tensor(np.ascontiguousarray(np.asarray(arr)), device=mesh.device)


class RowSharded:
    """An operator whose activations are row-sharded (the halo, the sharded
    hybrid, the sharded masked head): this rank holds ``rows_per`` rows."""

    @property
    def n_shards(self) -> int:
        return self.mesh.world_size

    @property
    def n_pad(self) -> int:
        return self.rows_per * self.n_shards

    @property
    def row_block(self) -> Tuple[int, int]:
        """``(N, first global row of this rank)``: a row-sharded activation
        draws its rows of the full-shape dropout mask
        (``models/layers.py::dropout``)."""
        return self.n_nodes, self.mesh.rank * self.rows_per


@dataclasses.dataclass
class ShardedAdj:
    """This rank's part of the row-partitioned normalized adjacency.

    src:       int32 [E_max] global source ids (0 on padding)
    dst_local: int32 [E_max] destination row local to the shard
    w:         float32 [E_max] normalized weights (0 on padding)
    self_w:    float32 [N] self-loop diagonal (replicated)
    n_edges:   this shard's real edges (the first ``n_edges`` entries)
    plan_fwd/plan_bwd: the CSR kernel's plans of this shard, forward
               ``[rows_per, N]`` (replicated x -> local rows) and transpose
               ``[N, rows_per]`` (local gradient rows -> this rank's part of
               the full cotangent), or None for the gather/``index_add_`` path.
    wire_rows: rows this rank's all_gather has moved in forward passes.
    """

    src: torch.Tensor
    dst_local: torch.Tensor
    w: torch.Tensor
    self_w: torch.Tensor
    n_nodes: int
    rows_per: int
    mesh: Mesh
    axis: str
    n_edges: int
    plan_fwd: Optional[CsrPlan] = None
    plan_bwd: Optional[CsrPlan] = None
    compute_dtype: str = "float32"
    wire_rows: int = 0

    @property
    def comm_rows_per_device(self) -> int:
        """Rows each rank receives per SpMM: the all_gather's other blocks
        (ring accounting, as ``hybrid_sharded.ring_gather_rows``)."""
        return (self.mesh.world_size - 1) * self.rows_per

    row_block = None  # activations are replicated

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return spmm_sharded(self, x)


def rank_plan(mesh: Mesh, rows, cols, w, n_rows: int, n_cols: int) -> CsrPlan:
    """``build_csr_plan`` of host edge arrays for the rank's device: a card
    plans from tensors there, the CPU from the arrays (the same plan bit
    for bit, ops/spmm_cuda.py)."""
    if mesh.device.type == "cuda":
        rows, cols, w = (torch.from_numpy(np.ascontiguousarray(a)) for a in (rows, cols, w))
    return build_csr_plan(rows, cols, w, n_rows, n_cols, mesh.device)


def build_sharded_adj(g: TextGraph, mesh: Mesh, axis: str = "graph", use_pallas: bool = False,
                      pallas_dtype: str = "float32") -> ShardedAdj:
    """Host-side partition, as the JAX package's (without its TPU row-block
    alignment): normalize, split edges by destination row block, pad shards
    to a uniform edge count; with ``use_pallas`` build this shard's CSR
    plans from its real edges (a shard may have none)."""
    if pallas_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"pallas_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {pallas_dtype!r}")
    n_dev = mesh.world_size
    src = np.asarray(g.edge_src, np.int64)
    dst = np.asarray(g.edge_dst, np.int64)
    norm_w, self_w = gcn_normalize_np(src, dst, np.asarray(g.edge_w), g.n_nodes)

    rows_per = -(-g.n_nodes // n_dev)
    shard_of_edge = dst // rows_per
    order = np.argsort(shard_of_edge, kind="stable")
    src, dst, norm_w = src[order], dst[order], norm_w[order]
    counts = np.bincount(shard_of_edge, minlength=n_dev)
    e_max = max(int(counts.max()), 1)

    src_s = np.zeros((n_dev, e_max), np.int32)
    dstl_s = np.zeros((n_dev, e_max), np.int32)
    w_s = np.zeros((n_dev, e_max), np.float32)
    starts = np.concatenate([[0], np.cumsum(counts)])
    for d in range(n_dev):
        lo, hi = starts[d], starts[d + 1]
        k = hi - lo
        src_s[d, :k] = src[lo:hi]
        dstl_s[d, :k] = dst[lo:hi] - d * rows_per
        w_s[d, :k] = norm_w[lo:hi]

    k = int(counts[mesh.rank])
    plan_fwd = plan_bwd = None
    if use_pallas:
        s_, d_, w_ = src_s[mesh.rank, :k], dstl_s[mesh.rank, :k], w_s[mesh.rank, :k]
        plan_fwd = rank_plan(mesh, d_, s_, w_, rows_per, g.n_nodes)
        plan_bwd = rank_plan(mesh, s_, d_, w_, g.n_nodes, rows_per)

    return ShardedAdj(
        src=put_global(mesh, src_s)[0],
        dst_local=put_global(mesh, dstl_s)[0],
        w=put_global(mesh, w_s)[0],
        self_w=replicate_global(mesh, self_w),
        n_nodes=g.n_nodes,
        rows_per=rows_per,
        mesh=mesh,
        axis=axis,
        n_edges=k,
        plan_fwd=plan_fwd,
        plan_bwd=plan_bwd,
        compute_dtype=pallas_dtype,
    )


# ------------------------------------------------------------ local math


def sharded_local_rows(adj: ShardedAdj, x: torch.Tensor) -> torch.Tensor:
    """This shard's output rows ``[rows_per, H]`` (f32) of ``(A - diag) @
    x`` for replicated ``x`` ``[N, H]``: the CSR kernel on the forward plan,
    x read in the compute dtype, or gather/``index_add_``."""
    if adj.plan_fwd is not None:
        return spmm_csr(adj.plan_fwd, x.to(_COMPUTE_DTYPES[adj.compute_dtype]).contiguous())
    k = adj.n_edges
    return segment_sum(adj.src[:k].long(), adj.dst_local[:k].long(), adj.w[:k], x,
                       adj.rows_per)


def sharded_local_cotangent(adj: ShardedAdj, g_local: torch.Tensor) -> torch.Tensor:
    """This shard's part ``[N, H]`` (f32) of the cotangent of x, from the
    gradient of its output rows ``[rows_per, H]``: the kernel on the
    transpose plan, or gather/``index_add_``."""
    if adj.plan_bwd is not None:
        return spmm_csr(adj.plan_bwd,
                        g_local.to(_COMPUTE_DTYPES[adj.compute_dtype]).contiguous())
    k = adj.n_edges
    return segment_sum(adj.dst_local[:k].long(), adj.src[:k].long(), adj.w[:k], g_local,
                       adj.n_nodes)


# ------------------------------------------------------------ collectives


def all_gather_rows(mesh: Mesh, local: torch.Tensor) -> torch.Tensor:
    """Every rank's ``[b, ...]`` block, concatenated in rank order."""
    if mesh.world_size == 1 and mesh.group is None:
        return local
    local = local.contiguous()
    parts = [torch.empty_like(local) for _ in range(mesh.world_size)]
    dist.all_gather(parts, local, group=mesh.group)
    return torch.cat(parts)


def all_reduce_sum(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place; returns it."""
    if not (mesh.world_size == 1 and mesh.group is None):
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=mesh.group)
    return t


def local_block(mesh: Mesh, t: torch.Tensor, rows_per: int) -> torch.Tensor:
    """Rows ``[r * rows_per, (r+1) * rows_per)`` of a replicated ``t``,
    zero-padded past its end."""
    lo = mesh.rank * rows_per
    blk = t[lo:lo + rows_per]
    if blk.shape[0] < rows_per:
        pad = t.new_zeros((rows_per - blk.shape[0], *t.shape[1:]))
        blk = torch.cat([blk, pad])
    return blk


class ShardedSpmmFunction(torch.autograd.Function):
    """``(A - diag) @ x`` for replicated x: local rows, then ``all_gather``;
    backward: this rank's gradient rows, the transpose, ``all_reduce``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, adj: ShardedAdj) -> torch.Tensor:
        ctx.adj, ctx.x_dtype = adj, x.dtype
        local = sharded_local_rows(adj, x)
        adj.wire_rows += adj.comm_rows_per_device
        return all_gather_rows(adj.mesh, local)[:adj.n_nodes]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        adj = ctx.adj
        part = sharded_local_cotangent(adj, local_block(adj.mesh, g, adj.rows_per))
        return all_reduce_sum(adj.mesh, part).to(ctx.x_dtype), None


def spmm_sharded(adj: ShardedAdj, x: torch.Tensor) -> torch.Tensor:
    """``A_hat @ x`` with the aggregation row-partitioned over the mesh;
    ``x`` ``[N, H]`` replicated, the result replicated."""
    return ShardedSpmmFunction.apply(x, adj) + adj.self_w[:, None] * x
