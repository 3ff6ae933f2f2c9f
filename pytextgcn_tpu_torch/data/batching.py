"""n-hop neighborhood mini-batching over document nodes.

Port of ``pytextgcn_tpu/data/batching.py``. The reference ships an
unfinished ``TextGCNBatcher`` whose sampler is an empty stub
(textgcn/lib/batching.py:9-55); this batches document nodes, expands their
n-hop incoming neighborhoods, and yields the induced edge set re-indexed
to local ids: a k-layer GCN's outputs at the batch nodes depend exactly on
their k-hop incoming fan-in, so a subgraph trains them exactly.

The batcher runs on the host in numpy and, with the same seed, yields the
JAX batcher's arrays bit for bit. ``pad_pow2`` pads them to powers of two
as the JAX batcher does to limit XLA's recompiles; :meth:`SubgraphBatch.to_adj`
leaves that padding out by default, since nothing here recompiles.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph, gcn_normalize_np
from ..ops.adjacency import NormAdj
from ..ops.spmm_cuda import build_plan_from_arrays


@dataclasses.dataclass
class SubgraphBatch:
    """A re-indexed neighborhood subgraph (numpy, host-side).

    nodes:       global node ids, local id i <-> nodes[i]; padded with -1
    batch_local: local ids of the seed documents (targets); padded with -1
    edge_src/edge_dst/edge_w: local-id edge list with **globally normalized**
                 weights (degrees computed on the full graph once, so batch
                 node outputs equal the full-graph GCN exactly; padding:
                 w=0 edges on node 0)
    self_w:      global self-loop weights for the subgraph's nodes
    """

    nodes: np.ndarray
    batch_local: np.ndarray
    edge_src: np.ndarray
    edge_dst: np.ndarray
    edge_w: np.ndarray
    self_w: np.ndarray
    n_real_nodes: int
    n_real_edges: int

    def to_adj(self, device: Union[str, torch.device], use_pallas: bool = True,
               pallas_dtype: str = "float32", real_only: bool = True) -> NormAdj:
        """The subgraph's prenormalized ``NormAdj`` on ``device``, over its
        real edges, with the CSR kernel's plan built on ``device`` from
        them (``use_pallas=False``: no plan, the segment path). It covers
        the first ``n_real_nodes`` local ids when ``real_only``, else every
        padded one too (those rows have no edges and a zero self-loop, so
        their outputs are zeros). The weights are the batch's globally
        normalized ones, never renormalized."""
        device = torch.device(device)
        n_nodes = self.n_real_nodes if real_only else len(self.nodes)
        e = self.n_real_edges
        src = torch.as_tensor(self.edge_src[:e]).to(device=device, dtype=torch.int64)
        dst = torch.as_tensor(self.edge_dst[:e]).to(device=device, dtype=torch.int64)
        w = torch.as_tensor(self.edge_w[:e]).to(device)
        plan = (build_plan_from_arrays(src, dst, w, n_nodes, compute_dtype=pallas_dtype,
                                       device=device) if use_pallas else None)
        return NormAdj(src=src, dst=dst, w=w,
                       self_w=torch.as_tensor(self.self_w[:n_nodes]).to(device),
                       n_nodes=n_nodes, plan=plan)


def _round_pow2(x: int) -> int:
    return 1 << max(0, int(np.ceil(np.log2(max(x, 1)))))


class NeighborhoodBatcher:
    def __init__(
        self,
        g: TextGraph,
        batch_size: int = 128,
        n_hops: int = 2,
        shuffle: bool = True,
        seed: int = 0,
        doc_mask: Optional[np.ndarray] = None,
        pad_pow2: bool = True,
    ):
        """``doc_mask``: boolean over *nodes* selecting which documents to
        batch (default: the graph's train_mask)."""
        self.g = g
        self.batch_size = batch_size
        self.n_hops = n_hops
        self.shuffle = shuffle
        self.seed = seed
        self.pad_pow2 = pad_pow2
        # one generator for the batcher's lifetime: each epoch (each
        # __iter__) draws a fresh permutation, deterministic given the seed
        self._rng = np.random.default_rng(seed)

        mask = np.asarray(g.train_mask if doc_mask is None else doc_mask)
        self.seed_nodes = np.flatnonzero(mask)

        # global symmetric normalization once: subgraph-local degrees would
        # be wrong at the neighborhood boundary
        norm_w, self._self_w = gcn_normalize_np(g.edge_src, g.edge_dst, g.edge_w, g.n_nodes)
        # incoming-edge CSR: for each dst node, its edge slice
        dst = np.asarray(g.edge_dst, np.int64)
        self._order = np.argsort(dst, kind="stable")
        self._src_sorted = np.asarray(g.edge_src, np.int64)[self._order]
        self._dst_sorted = dst[self._order]
        self._w_sorted = norm_w[self._order]
        counts = np.bincount(dst, minlength=g.n_nodes)
        self._indptr = np.concatenate([[0], np.cumsum(counts)])

    def __len__(self) -> int:
        return -(-len(self.seed_nodes) // self.batch_size)

    def _incoming(self, nodes: np.ndarray) -> np.ndarray:
        """Positions (in dst-sorted order) of all edges into ``nodes``: each
        node's range [indptr[v], indptr[v+1]), emitted by one arange plus
        per-range offsets."""
        starts = self._indptr[nodes]
        lens = self._indptr[nodes + 1] - starts
        total = int(lens.sum())
        if total == 0:
            return np.zeros(0, np.int64)
        cum = np.cumsum(lens)
        offsets = np.repeat(starts - (cum - lens), lens)
        return np.arange(total, dtype=np.int64) + offsets

    def __iter__(self) -> Iterator[SubgraphBatch]:
        order = self.seed_nodes.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        for off in range(0, len(order), self.batch_size):
            batch = order[off : off + self.batch_size]
            known = np.unique(batch)  # sorted unique node universe so far
            frontier = known
            edge_pos = []
            for _ in range(self.n_hops):
                pos = self._incoming(frontier)
                edge_pos.append(pos)
                new = np.unique(self._src_sorted[pos])
                frontier = new[~np.isin(new, known, assume_unique=True)]
                if frontier.size == 0:
                    break
                known = np.union1d(known, frontier)
            # dedupe by edge position (multi-edges between the same node pair
            # are real and must both survive: the full graph sums them)
            pos = np.unique(np.concatenate(edge_pos)) if edge_pos else np.zeros(0, np.int64)
            src = self._src_sorted[pos]
            dst = self._dst_sorted[pos]
            w = self._w_sorted[pos]

            # `known` is sorted-unique, so local id == searchsorted rank
            nodes = known
            src_l = np.searchsorted(nodes, src).astype(np.int32)
            dst_l = np.searchsorted(nodes, dst).astype(np.int32)
            batch_l = np.searchsorted(nodes, batch).astype(np.int32)

            n_nodes_pad = _round_pow2(len(nodes)) if self.pad_pow2 else len(nodes)
            n_edges_pad = _round_pow2(len(src_l)) if self.pad_pow2 else len(src_l)
            nodes_p = np.full(n_nodes_pad, -1, np.int64)
            nodes_p[: len(nodes)] = nodes
            sp = np.zeros(n_edges_pad, np.int32)
            dp = np.zeros(n_edges_pad, np.int32)
            wp = np.zeros(n_edges_pad, np.float32)
            sp[: len(src_l)] = src_l
            dp[: len(dst_l)] = dst_l
            wp[: len(w)] = w
            bl = np.full(_round_pow2(len(batch_l)) if self.pad_pow2 else len(batch_l), -1,
                         np.int32)
            bl[: len(batch_l)] = batch_l
            self_w = np.zeros(n_nodes_pad, np.float32)
            self_w[: len(nodes)] = self._self_w[nodes]
            yield SubgraphBatch(
                nodes=nodes_p,
                batch_local=bl,
                edge_src=sp,
                edge_dst=dp,
                edge_w=wp,
                self_w=self_w,
                n_real_nodes=len(nodes),
                n_real_edges=len(src_l),
            )
