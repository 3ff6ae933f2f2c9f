"""Full-batch and mini-batch training engine.

Port of ``pytextgcn_tpu/train/trainer.py``: ``fit`` with ``eval_every``,
the 'reference' / 'val_f1' early-stopping rules and ``start_epoch``,
``fit_minibatch`` (n-hop neighborhood subgraphs, data/batching.py),
``evaluate``, ``predict_logits``, ``save`` / ``restore`` and
``share_adjacency``. A train step is forward, masked
cross-entropy, backward and an optimizer step; the default optimizer is
``torch.optim.Adam(amsgrad=True)``, the reference's update rule
(flat_amazon.py:89), as ``train/optim.py::Adam``, whose step on the card
is one hand-written kernel.

``Aggregation`` chooses and builds the aggregation operator; each operator
applies itself (ops/spmm.py). With ``use_pallas`` (the default) it runs in
the hand-written CSR kernel: 2 launches per forward pass and 2 more in the
backward pass, so 4 per train step and 2 per evaluation. With ``hybrid_k``
it runs the hybrid decomposition instead, whose dual kernel and residual
CSR kernel launch that many times each. With ``masked_head`` the final
layer aggregates into the train rows only during ``fit``
(ops/restricted.py): 2 of the step's 4 launches then run on the
restricted plans. With ``debug_checks`` every step checks that the loss,
each gradient and each parameter are finite, on whichever of these paths
the trainer runs.

With a ``mesh`` (parallel/) the aggregation is partitioned over the ranks
of a process group, one trainer per rank, each seeded alike. 'allgather'
(``ShardedAdj``): activations replicated, each rank's kernel runs its row
block's plan (2 launches a forward pass and 2 a backward pass, as on one
device), and everything else runs identically on every rank. ``halo``
(``HaloAdj``): activations, labels and masks are the rank's rows; the loss
divides by the global train count, parameter gradients are summed over the
ranks before the optimizer step, and the metrics sum their counts over the
ranks; each SpMM runs the kernel on the own block and on each ring step's
block, forward and transpose. ``halo`` with ``hybrid_k``
(``HybridShardedAdj``): the same layout, each rank's dense hot block on the
dual kernel (``hybrid_fused``) or two ``torch.matmul``, the cold residual
on the halo's plans; a K of 0 (or an 'auto' that picks none) falls back to
the pure halo. ``masked_head`` with a mesh: the sharded restricted head,
row-sharded and zero at non-train rows, so labels and masks stay whole.

With a ``tp_mesh`` (parallel/tensor.py) EGCN's embedding is cut by columns
over its ranks, one all_reduce a forward pass; each rank's optimizer runs
over its own blocks, and checkpoints keep the single-device layout. Beside
a graph ``mesh`` over the same ranks the embedding runs over every row
(the features stay whole under the halo), the summed first contraction
feeds the partition as a replicated activation, or its rank's rows under
the halo, and the halo's sum of gradients over the ranks leaves the cut
blocks out: each rank's block already has the gradient of every row.

On one card ``fit`` runs each epoch as two CUDA-graph replays
(``train/graphs.py``): the train step's forward, loss and backward, then,
at evaluation points, the evaluation; the optimizer runs eagerly between
them. Each graph is captured once the trainer has run its work eagerly on
the operator (the step's graph at the second epoch, the evaluation's at the
evaluation point after the first), and kept across ``fit`` calls. The step runs eagerly instead where
the trainer observes what a replay cannot give: the CPU, a ``mesh`` or
``tp_mesh``, ``debug_checks`` (which read every step), an operator other
than the CSR kernel's, or a gradient hook on a parameter (autograd calls
hooks only in an eager step).
``graph_stats`` counts the replayed and the eager epochs. Either way an
epoch reads the device once: the loss and, at evaluation points, the
evaluation's three numbers, in one copy.

While a ``torch.profiler`` runs, ``fit`` and ``fit_minibatch`` mark their
phases with spans (``train/profiling.py``): ``fit.epoch`` around each epoch,
and inside it ``fit.train_step`` and ``fit.eval`` (the enqueue; each holds a
``fit.replay`` span, ``graph=T`` or ``E``, where it replays), one
``fit.host_read`` for the epoch's read from the device, and ``fit.log``.
Each ``fit`` call is the stage ``trainer.fit``; a capture, the stage
``trainer.capture``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph
from ..models import JumpingKnowledgeNetwork, export_params, load_jax_params
from ..models.jk import JK_NO_MASKED_HEAD
from ..ops.adjacency import NormAdj
from ..ops.features import NodeFeatures
from ..ops.restricted import build_restricted_adj
from ..ops.spmm_cuda import SpmmPlan
from ..parallel import (ReplicatedHead, build_halo_adj, build_hybrid_sharded_adj,
                        build_restricted_sharded_adj, build_sharded_adj)
from ..parallel.sharded import Mesh, all_gather_rows, local_block
from ..parallel.tensor import (apply_tp, apply_tp_state, gather_optimizer_state, gather_params,
                               shard_params, tp_param_shardings)
from ..utils import resolve_device
from .checkpoint import load_checkpoint, load_meta, save_checkpoint
from .graphs import EpochGraphs, hooked
from .metrics import accuracy, global_count, macro_f1, masked_cross_entropy
from .optim import resolve_optimizer
from .profiling import span, stage

# What fit's one read per epoch holds, in order: the train loss, then the
# evaluation's numbers (_eval_step's keys)
EPOCH_READ = ("loss", "val_loss", "val_f1", "train_acc")


def dropout_seed(seed: int) -> int:
    """The seed of the dropout generator of a trainer seeded ``seed``: a fixed
    mix of it, never ``seed`` itself. The drivers draw the parameters from
    ``torch.Generator().manual_seed(seed)``; a CPU dropout generator seeded
    with the same integer replays that stream, so the first mask would keep
    exactly the lowest ``1 - rate`` of W1's initial entries, and the cascade's
    macro-F1 drifted up 2.4 standard errors against the JAX package's on the
    CPU (PERF.md). The JAX trainer splits its key for the same reason."""
    return (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % 2**63


@dataclasses.dataclass(frozen=True)
class Aggregation:
    """``Trainer``'s operator settings. ``use_pallas``: aggregate through
    the CSR kernel (else the plain gather/``index_add_`` path).
    ``pallas_dtype``: the kernel's input dtype, 'float32' or 'bfloat16'
    (parameters, optimizer and loss stay f32). ``hybrid_k`` /
    ``hybrid_fused`` / ``hybrid_f32_mode``: the hybrid decomposition
    (ops/hybrid.py), as ``NormAdj.from_graph`` takes them; 'auto' prices it
    at the model's hidden width. ``plan_cache``: a directory of persisted
    plans (ops/plan_cache.py). ``mesh``: a ``parallel.Mesh`` (``make_mesh``)
    the operator is partitioned over, by 'allgather' or, with ``halo``, by
    the halo exchange (the sharded hybrid with ``hybrid_k`` besides).
    Trainers whose values are equal may share one operator
    (``Trainer.share_adjacency``)."""

    use_pallas: bool = True
    pallas_dtype: str = "float32"
    hybrid_k: Optional[Union[int, str]] = None
    hybrid_fused: Optional[bool] = None
    hybrid_f32_mode: Optional[str] = None
    plan_cache: Optional[str] = None
    mesh: Optional[Mesh] = None
    halo: bool = False

    def __post_init__(self):
        if self.mesh is not None:
            if self.plan_cache is not None:
                raise ValueError("plan_cache with a mesh: a plan cache holds one device's "
                                 "operator, which a mesh never builds (ROADMAP.md §1)")
            if self.hybrid_k is not None and not self.halo:
                raise ValueError("hybrid_k with the 'allgather' partition: it has no hybrid "
                                 "form; the sharded hybrid needs halo=True (ROADMAP.md §1)")
            if self.hybrid_f32_mode == "split2":
                raise ValueError("hybrid_f32_mode='split2' with a mesh: the sharded hybrid's "
                                 "f32 products are 'highest' (ROADMAP.md §1)")
        if self.halo and self.mesh is None:
            raise ValueError("halo=True needs a mesh")

    @property
    def group(self):
        """The process group the metrics and gradients are summed over: the
        halo mesh's, else None (every rank holds every row)."""
        return self.mesh.group if self.halo else None

    def operator(self, g: TextGraph, device: torch.device, h_hint: int = 128, batch: int = 1):
        """The operator over ``g``'s edges; the hybrid's cost model prices
        ``batch`` members applying it together at width ``h_hint``."""
        if self.mesh is None:
            return NormAdj.from_graph(
                g, use_pallas=self.use_pallas, pallas_dtype=self.pallas_dtype, device=device,
                hybrid_k=self.hybrid_k, hybrid_fused=self.hybrid_fused,
                hybrid_f32_mode=self.hybrid_f32_mode, hybrid_batch=batch, h_hint=h_hint,
                plan_cache=self.plan_cache)
        if not self.halo:
            return build_sharded_adj(g, self.mesh, use_pallas=self.use_pallas,
                                     pallas_dtype=self.pallas_dtype)
        adj = None
        if self.hybrid_k is not None:  # None: no hot set, the pure halo
            adj = build_hybrid_sharded_adj(
                g, self.mesh, hot_k=self.hybrid_k, compute_dtype=self.pallas_dtype,
                h_hint=h_hint, fused=self.hybrid_fused, use_pallas=self.use_pallas)
        if adj is None:
            adj = build_halo_adj(g, self.mesh, use_pallas=self.use_pallas,
                                 compute_dtype=self.pallas_dtype)
        return adj

    def head(self, g: TextGraph, rows: np.ndarray, device: torch.device, out_dim: int):
        """The masked head's operator into ``rows`` (the train rows), as the
        JAX trainer builds it: on the CSR kernel when the full operator uses
        a kernel, with the restricted cost model's K when the full operator
        is hybrid. With a mesh, the sharded restricted head, on replicated
        activations under 'allgather'."""
        hot_k = "auto" if self.hybrid_k is not None else None
        if self.mesh is None:
            return build_restricted_adj(
                g, rows, use_pallas=self.use_pallas or hot_k is not None, hot_k=hot_k,
                compute_dtype=self.pallas_dtype, h_hint=out_dim, device=device)
        head = build_restricted_sharded_adj(
            g, rows, self.mesh, hot_k=hot_k, compute_dtype=self.pallas_dtype,
            use_pallas=self.use_pallas, h_hint=out_dim)
        return head if self.halo else ReplicatedHead(head)

    def on_csr_kernel(self, adj) -> bool:
        """Whether ``adj``, an operator of this value's, is the CSR kernel's
        on one device (not the segment path, the hybrid or a partition)."""
        return self.mesh is None and isinstance(adj.plan, SpmmPlan)


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        lr: float = 0.05,
        seed: int = 0,
        optimizer: Optional[str] = None,  # None | "adam" | "torch_amsgrad"
        use_pallas: bool = True,
        pallas_dtype: str = "float32",
        device: Optional[Union[str, torch.device]] = None,
        hybrid_k: Optional[Union[int, str]] = None,
        hybrid_fused: Optional[bool] = None,
        hybrid_f32_mode: Optional[str] = None,
        masked_head: bool = False,
        plan_cache: Optional[str] = None,
        debug_checks: bool = False,
        mesh=None,
        halo: bool = False,
        tp_mesh=None,
    ):
        """``seed`` seeds the dropout generator (parameters come with the
        model). ``device``: None means the GPU (raises without one), and a
        ``mesh`` or ``tp_mesh``'s device where one is given. ``use_pallas``,
        ``pallas_dtype``, ``hybrid_k``, ``hybrid_fused``,
        ``hybrid_f32_mode``, ``plan_cache``, ``mesh`` and ``halo`` choose
        the aggregation operator: they make the trainer's ``aggregation``
        (``Aggregation``), which says what each means. ``masked_head``:
        the final layer aggregates into the train rows only during ``fit``
        (exact for GCN; EGCN's dropout on the logits then draws a mask of
        another shape, so its run is statistically equal, not step for
        step; the JK network has no masked head). ``debug_checks``:
        after every step, raise ``FloatingPointError`` naming the epoch and
        the tensor when the loss, a gradient or a parameter holds a NaN or
        an Inf. The step keeps its path (kernel, hybrid, masked head), so a
        NaN the kernel produces is caught too; the checks read the device
        every step. (The JAX trainer's checkify mode runs the segment path,
        since checkify cannot instrument its Pallas kernel; pass
        ``use_pallas=False`` for that path here.) ``tp_mesh``: a
        ``parallel.Mesh`` over which EGCN's embedding is cut by columns
        (``make_mesh(axis="model")``), alone or beside a ``mesh`` over the
        same ranks."""
        if masked_head and isinstance(model, JumpingKnowledgeNetwork):
            raise ValueError(JK_NO_MASKED_HEAD)
        if mesh is not None and tp_mesh is not None and (
                (mesh.world_size, mesh.rank, mesh.device)
                != (tp_mesh.world_size, tp_mesh.rank, tp_mesh.device)):
            raise ValueError("a tp_mesh beside a graph mesh spans the same ranks: rank "
                             f"{tp_mesh.rank} of {tp_mesh.world_size} on {tp_mesh.device} "
                             f"against {mesh.rank} of {mesh.world_size} on {mesh.device}")
        self.aggregation = Aggregation(use_pallas, pallas_dtype, hybrid_k, hybrid_fused,
                                       hybrid_f32_mode, plan_cache, mesh, halo)
        if mesh is not None or tp_mesh is not None:
            group_device = (mesh or tp_mesh).device
            if device is not None and torch.device(device) != group_device:
                raise ValueError(f"device {device} is not the mesh's {group_device}")
            device = group_device
        self.tp_mesh = tp_mesh
        self.device = resolve_device(device)
        if tp_mesh is not None:
            apply_tp(model, tp_mesh)
        self.model = model.to(self.device)
        self.lr = lr
        self.seed = seed
        self.masked_head = masked_head
        self.debug_checks = debug_checks
        self.optimizer = resolve_optimizer(optimizer, self.model.parameters(), lr)
        # one dropout stream per trainer; each fit continues it, so refits
        # draw fresh masks (the JAX trainer folds in a fit counter instead)
        self.generator = torch.Generator(device=self.device).manual_seed(dropout_seed(seed))
        # the operator, the graph it was built over, the features; the head's
        self._adj = None
        self._adj_key: Optional[TextGraph] = None
        self._feats: Optional[NodeFeatures] = None
        self._adj_out = None
        self._adj_out_key: Optional[tuple] = None
        self._restored = False
        # fit's CUDA graphs (train/graphs.py), and the keys of the last eager
        # step and evaluation, which warm them up
        self._graphs: Optional[EpochGraphs] = None
        self._warm_step: Optional[tuple] = None
        self._warm_eval: Optional[tuple] = None
        # fit's epochs whose step ran as a graph replay, and eagerly
        self.graph_stats = {"replayed": 0, "eager": 0}
        # fit_minibatch's host-clock seconds a batch: batcher, plan, step
        self.minibatch_seconds: List[Dict[str, float]] = []

    # ------------------------------------------------------------ internals

    def prepare(self, g: TextGraph):
        """Finalize the graph into the operator + feature structures. The
        operator (normalization + kernel plan) is cached by edge-array
        identity, like the JAX trainer's."""
        old = self._adj_key
        if (old is None or old.edge_src is not g.edge_src or old.edge_w is not g.edge_w
                or old.n_nodes != g.n_nodes):
            self.adopt(self.aggregation.operator(
                g, self.device, h_hint=getattr(self.model, "n_hidden", 128)), g)
        self._feats = NodeFeatures.from_graph(g, device=self.device)
        if self.aggregation.halo and getattr(self.model, "tp", None) is None:
            # the rank's rows of the first layer's input (a TP embedding
            # takes every row)
            _, lo = self._adj.row_block
            self._feats = self._feats.row_block(lo, self._adj.rows_per)
        return self._adj, self._feats

    def adopt(self, adj, g: TextGraph, feats: Optional[NodeFeatures] = None) -> None:
        """Take ``adj``, built by an ``aggregation`` equal to this trainer's
        over ``g``'s edges, as the operator (and ``feats`` as the features):
        :meth:`prepare` keeps it for every graph of the same edge arrays."""
        if adj is not self._adj:
            self._drop_graphs()
        self._adj, self._adj_key = adj, g
        if feats is not None:
            self._feats = feats

    def _local(self, t: torch.Tensor) -> torch.Tensor:
        """A per-node tensor as this trainer's operator holds its rows: a
        halo rank's block, padded with zeros (False) past the last node;
        whole elsewhere."""
        if not self.aggregation.halo:
            return t
        return local_block(self.aggregation.mesh, t, self._adj.rows_per)

    def share_adjacency(self, other: "Trainer") -> None:
        """Adopt another trainer's prepared operator (normalization and
        kernel plan). Hierarchy cascades and ensembles swap labels, masks
        and features with ``dataclasses.replace`` while the edge arrays stay
        the same objects, so their members can share one build. Nothing is
        adopted unless the device, the ``aggregation`` and the ``tp_mesh``
        are equal; :meth:`prepare`'s edge-identity check still guards
        against a different graph."""
        settings = lambda t: (t.device, t.aggregation, t.tp_mesh)
        if other._adj is None or settings(self) != settings(other):
            return
        self.adopt(other._adj, other._adj_key)
        if other._adj_out is not None and self.masked_head and other.masked_head:
            self._adj_out, self._adj_out_key = other._adj_out, other._adj_out_key

    def _prepare_restricted(self, g: TextGraph):
        """The masked head's operator over the train rows
        (``Aggregation.head``), cached by edge-array and train-mask identity
        (members of an ensemble share edges but differ in masks)."""
        key = (g.edge_src, g.edge_w, g.train_mask)
        old = self._adj_out_key
        if old is None or not all(a is b for a, b in zip(old, key)):
            self._adj_out = self.aggregation.head(g, np.flatnonzero(np.asarray(g.train_mask)),
                                                  self.device, self.model.out_dim)
            self._adj_out_key = key
        return self._adj_out

    def _loss_backward(self, adj, feats, y, mask, adj_out=None,
                       denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The step's forward, masked cross-entropy and backward (what graph
        T holds); returns the loss."""
        logits = self.model(adj, feats, train=True, generator=self.generator,
                            adj_out=adj_out)
        loss = masked_cross_entropy(logits, y, mask, denom)
        loss.backward()
        return loss

    def _train_step(self, adj, feats, y, mask, adj_out=None, epoch: int = 0,
                    denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One step; returns the loss. ``denom``: the halo's global train
        count (the rank's loss is its part of the sum, and the gradients
        and the returned loss are summed over the ranks)."""
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_backward(adj, feats, y, mask, adj_out, denom)
        if self.aggregation.halo:
            loss = self._sum_over_ranks(loss.detach())
        if self.debug_checks:
            self._check_finite(epoch, [("loss", loss)] + [
                (f"gradient of {name}", p.grad) for name, p in self.model.named_parameters()
                if p.grad is not None])
        self.optimizer.step()
        if self.debug_checks:
            self._check_finite(epoch, [(f"parameter {name}", p)
                                       for name, p in self.model.named_parameters()])
        return loss.detach()

    def _sum_over_ranks(self, loss: torch.Tensor) -> torch.Tensor:
        """Halo: sum each whole parameter's gradient (one flat all_reduce)
        and the loss over the ranks; returns the summed loss. A TP rank's
        cut blocks are left out: their gradients are whole already."""
        cut = tp_param_shardings(self.model) if self.tp_mesh is not None else {}
        grads = [p.grad for name, p in self.model.named_parameters()
                 if p.grad is not None and cut.get(name) is None]
        flat = torch.cat([g.flatten() for g in grads] + [loss.reshape(1)])
        torch.distributed.all_reduce(flat, group=self.aggregation.group)
        off = 0
        for g in grads:
            g.copy_(flat[off:off + g.numel()].view_as(g))
            off += g.numel()
        return flat[-1]

    @staticmethod
    def _check_finite(epoch: int, tensors) -> None:
        """Raise at the first of ``tensors`` ((name, tensor) pairs) that
        holds a NaN or an Inf (debug mode: each check reads the device)."""
        for name, t in tensors:
            if bool(torch.isnan(t).any()):
                raise FloatingPointError(f"debug_checks: {name} holds nan at epoch {epoch + 1}")
            if bool(torch.isinf(t).any()):
                raise FloatingPointError(f"debug_checks: {name} holds inf at epoch {epoch + 1}")

    @torch.no_grad()
    def _eval_step(self, adj, feats, y, train_mask, val_mask, n_classes: int,
                   val_denom: Optional[torch.Tensor] = None):
        logits = self.model(adj, feats, train=False)
        pred = logits.argmax(dim=-1)
        group = self.aggregation.group
        val_loss = masked_cross_entropy(logits, y, val_mask, val_denom)
        if group is not None:
            torch.distributed.all_reduce(val_loss, group=group)
        return {
            "val_loss": val_loss,
            "val_f1": macro_f1(pred, y, val_mask, n_classes, group),
            "train_acc": accuracy(pred, y, train_mask, group),
        }

    def _eval_result(self, adj, feats, y, train_mask, val_mask, loss: torch.Tensor,
                     n_classes: int, val_denom: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The evaluation beside the step's ``loss``: the ``EPOCH_READ``
        numbers as one ``[4]`` tensor (what graph E holds)."""
        m = self._eval_step(adj, feats, y, train_mask, val_mask, n_classes, val_denom)
        return torch.stack([loss] + [m[k] for k in EPOCH_READ[1:]])

    def _graph_key(self, adj, adj_out, inputs, n_classes: int) -> Optional[tuple]:
        """What fit's graphs are captured for: the operators (by identity),
        the classes, each parameter's storage and shape and each input's
        shape and dtype. None where the trainer's fit runs eagerly: off the
        card, over a mesh, with debug checks, or on an operator other than
        the CSR kernel's (the segment path's atomics make even two eager fits
        differ; the hybrid). The masked head's operator then runs on the CSR
        kernel too."""
        if (self.device.type != "cuda" or self.tp_mesh is not None or self.debug_checks
                or not self.aggregation.on_csr_kernel(adj)):
            return None
        return (adj, adj_out, n_classes,
                tuple((p.data_ptr(), p.shape) for p in self.model.parameters()),
                tuple(None if t is None else (t.shape, t.dtype) for t in inputs))

    @staticmethod
    def _same_key(a: Optional[tuple], b: Optional[tuple]) -> bool:
        return (a is not None and b is not None and a[0] is b[0] and a[1] is b[1]
                and a[2:] == b[2:])

    def _drop_graphs(self) -> None:
        """Forget fit's graphs and their warm-up (a new operator, restored
        state): the next epoch runs eagerly, the one after captures."""
        self._graphs = None
        self._warm_step = self._warm_eval = None

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ api

    @stage("trainer.fit")
    def fit(
        self,
        g: TextGraph,
        epochs: int = 500,
        n_classes: Optional[int] = None,
        verbose: int = 0,
        eval_every: int = 1,
        early_stopping: Optional[str] = None,  # None | 'reference' | 'val_f1'
        patience: int = 10,
        min_epochs: int = 30,
        log_fn: Callable[[str], None] = print,
        start_epoch: int = 0,
    ) -> List[Dict[str, float]]:
        """Train on the full graph; returns per-epoch history.

        ``early_stopping='reference'`` replicates flat_amazon.py:121-123
        (stop when the train loss 5 epochs ago beat the current one);
        ``'val_f1'`` is the patience scheme of MLP_flat.py:54,100-110.

        ``start_epoch``: the resume point returned by :meth:`restore`. The
        restored optimizer and dropout-generator state continue exactly
        where the saved run stopped, so the resumed run gives bit for bit
        the parameters of an uninterrupted one. As in the JAX trainer, the
        early-stopping windows restart at the resume point.
        """
        if early_stopping not in (None, "reference", "val_f1"):
            raise ValueError(f"unknown early_stopping {early_stopping!r}")
        if start_epoch and not self._restored:
            raise ValueError("start_epoch > 0 resumes a run: call Trainer.restore(path) first")
        if n_classes is None:
            n_classes = int(np.max(np.asarray(g.y))) + 1
        adj, feats = self.prepare(g)
        y = self._local(self._tensor(g.y, torch.int64))
        train_mask = self._local(self._tensor(g.train_mask))
        val_mask = self._local(self._tensor(g.val_mask))
        denom = val_denom = None
        if self.aggregation.halo:  # the global counts, once
            denom = global_count(train_mask, self.aggregation.group)
            val_denom = global_count(val_mask, self.aggregation.group)
        adj_out, y_step, mask_step = None, y, train_mask
        if self.masked_head:
            adj_out = self._prepare_restricted(g)
            if self.aggregation.mesh is None:
                # logits at the train rows only: labels sliced to them, every
                # row counted, so the loss sees the full step's terms (over
                # ranks the head keeps every row, zero off the train rows)
                y_step = y.index_select(0, adj_out.rows)
                mask_step = torch.ones(adj_out.m, dtype=torch.bool, device=self.device)

        inputs = (y, train_mask, val_mask, y_step, mask_step, feats.x, feats.hierarchy)
        key = self._graph_key(adj, adj_out, inputs, n_classes)
        graphs = self._graphs
        if graphs is not None and self._same_key(graphs.key, key):
            graphs.load(inputs)
        else:
            graphs = self._graphs = None
        params = list(self.model.parameters())

        history: List[Dict[str, float]] = []
        f1_hist: List[float] = []  # val F1 at eval points (for 'val_f1' ES)
        width = len(str(epochs))
        t0 = time.time()
        for epoch in range(start_epoch, epochs):
            with span("fit.epoch", epoch=epoch + 1):
                eager = hooked(params)  # a hook is called only in an eager step
                if graphs is None and not eager and self._same_key(self._warm_step, key):
                    graphs = self._graphs = EpochGraphs(key, params, self.generator, adj, feats,
                                                        adj_out, inputs, self._loss_backward)
                replay = graphs is not None and not eager
                with span("fit.train_step"):
                    if replay:
                        loss = graphs.step(self.optimizer)
                    else:
                        loss = self._train_step(adj, feats, y_step, mask_step, adj_out, epoch,
                                                denom)
                        if graphs is not None:  # graph E reads T's loss buffer
                            graphs.loss.copy_(loss)
                        self._warm_step = key
                self.graph_stats["replayed" if replay else "eager"] += 1
                # the epoch's one read from the device, once its evaluation is
                # enqueued: the loss with the evaluation's numbers at evaluation
                # points, the loss alone on other epochs of the reference rule
                is_eval = (epoch + 1) % eval_every == 0 or epoch == epochs - 1
                if is_eval:
                    with span("fit.eval"):
                        if (graphs is not None and graphs.eval_graph is None
                                and self._same_key(self._warm_eval, key)):
                            graphs.capture_eval(
                                lambda *a: self._eval_result(*a, n_classes=n_classes))
                        if graphs is not None and graphs.eval_graph is not None:
                            out = graphs.evaluate()
                        else:
                            out = self._eval_result(adj, feats, y, train_mask, val_mask, loss,
                                                    n_classes, val_denom)
                            self._warm_eval = key
                    with span("fit.host_read"):
                        rec = dict(zip(EPOCH_READ, out.tolist()))
                    if verbose > 0:
                        with span("fit.log"):
                            log_fn(
                                f"[{epoch + 1:{width}}] loss: {rec['loss']: .3f}, "
                                f"training accuracy: {rec['train_acc']: .3f}, "
                                f"val_f1: {rec['val_f1']: .3f}"
                            )
                    if early_stopping == "val_f1":
                        # the reference MLP rule (MLP_flat.py:95-100): stop when
                        # each of the last `patience` F1s is <= the F1 from
                        # patience+1 evals ago (no best-params restore)
                        f1_hist.append(rec["val_f1"])
                        if epoch > min_epochs and len(f1_hist) > patience:
                            dec = sum(
                                f1_hist[-(i + 1)] <= f1_hist[-(patience + 1)]
                                for i in range(patience)
                            )
                            if dec >= patience:
                                if verbose > 0:
                                    with span("fit.log"):
                                        log_fn(f"Early stopping! Validation f1 decreased "
                                               f"for {dec} epochs!")
                                history.append(rec)
                                break
                elif early_stopping == "reference":
                    with span("fit.host_read"):
                        rec = {"loss": loss.item()}
                else:  # read after the loop; a replay's buffer is written again
                    rec = {"loss": loss.clone() if replay else loss}
                history.append(rec)
                if (
                    early_stopping == "reference"
                    and epoch > 5
                    and len(history) >= 5
                    and history[-5]["loss"] < history[-1]["loss"]
                ):
                    if verbose > 0:
                        with span("fit.log"):
                            log_fn("early stopping activated!")
                    break
        if verbose > 0:
            with span("fit.log"):
                log_fn(f"training took {time.time() - t0:.2f}s for {len(history)} epochs")
        return [{k: float(v) for k, v in rec.items()} for rec in history]

    def fit_minibatch(
        self,
        g: TextGraph,
        epochs: int = 1,
        batch_size: int = 128,
        n_hops: Optional[int] = None,
        n_classes: Optional[int] = None,
        verbose: int = 0,
        log_fn: Callable[[str], None] = print,
    ) -> List[Dict[str, float]]:
        """Mini-batched training on n-hop neighborhood subgraphs
        (data/batching.py), the workflow the reference's unfinished
        ``TextGCNBatcher`` aimed at (batching.py:9-55).

        Each step trains on a re-indexed subgraph whose globally normalized
        weights give the full-graph GCN's outputs at the batch's documents
        exactly (``n_hops`` defaults to the model's depth, enough fan-in).
        The subgraph's CSR plan is built on the trainer's device from its
        real edges (``use_pallas``; else the segment path), so the kernel
        runs 4 times a step, over no padding. Dropout draws from the
        trainer's generator, whose stream moves on every step. The hybrid,
        the masked head and the plan cache act on the full graph's operator
        and are refused here. ``n_classes`` is accepted as the JAX trainer
        accepts it; the loss does not need it.

        Returns the per-epoch history with the mean batch loss; the
        host-clock seconds of each batch's batcher, plan build and step
        (synchronized on the card) are in ``self.minibatch_seconds``."""
        from ..data.batching import NeighborhoodBatcher

        agg = self.aggregation
        refused = [name for name, on in (("hybrid_k", agg.hybrid_k is not None),
                                         ("masked_head", self.masked_head),
                                         ("plan_cache", agg.plan_cache is not None),
                                         ("a mesh", agg.mesh is not None),
                                         ("a tp_mesh", self.tp_mesh is not None)) if on]
        if refused:
            raise ValueError(f"fit_minibatch does not run {', '.join(refused)}: "
                             "they act on the full graph's operator")
        if n_hops is None:
            n_hops = getattr(self.model, "n_gcn", 2)
        batcher = NeighborhoodBatcher(g, batch_size=batch_size, n_hops=n_hops, seed=self.seed,
                                      pad_pow2=False)
        feats_full = NodeFeatures.from_graph(g, device=self.device)
        y_full = self._tensor(g.y, torch.int64)
        on_card = self.device.type == "cuda"
        sync = (lambda: torch.cuda.synchronize(self.device)) if on_card else (lambda: None)

        self.minibatch_seconds = []
        history: List[Dict[str, float]] = []
        t_start = time.time()
        for epoch in range(epochs):
            with span("fit.epoch", epoch=epoch + 1):
                losses = []
                batches = iter(batcher)
                while True:
                    t0 = time.perf_counter()
                    sub = next(batches, None)
                    if sub is None:
                        break
                    t1 = time.perf_counter()
                    adj = sub.to_adj(self.device, use_pallas=agg.use_pallas,
                                     pallas_dtype=agg.pallas_dtype)
                    sync()
                    t2 = time.perf_counter()
                    nodes = self._tensor(sub.nodes[:adj.n_nodes])
                    mask = torch.zeros(adj.n_nodes, dtype=torch.bool, device=self.device)
                    mask[self._tensor(sub.batch_local[sub.batch_local >= 0],
                                      torch.int64)] = True
                    with span("fit.train_step"):
                        losses.append(self._train_step(adj, feats_full.subgraph(nodes),
                                                       y_full[nodes.clamp(min=0)], mask,
                                                       epoch=epoch))
                    sync()
                    self.minibatch_seconds.append({"batcher": t1 - t0, "plan": t2 - t1,
                                                   "step": time.perf_counter() - t2})
                with span("fit.host_read"):
                    mean_loss = float(torch.stack(losses).mean())
                history.append({"loss": mean_loss})
                if verbose > 0:
                    with span("fit.log"):
                        log_fn(f"[{epoch + 1}] minibatch mean loss: {mean_loss: .4f}")
        if verbose > 0:
            with span("fit.log"):
                log_fn(f"minibatch training took {time.time() - t_start:.2f}s "
                       f"({epochs} epochs x {len(batcher)} batches)")
        return history

    def save(self, path: str, epoch: int) -> None:
        """Checkpoint the parameters (in the JAX package's layout), the
        optimizer and dropout-generator state and the epoch counter:
        everything :meth:`fit` needs to resume bit for bit. With a mesh,
        rank 0 writes (every rank holds the same state) and the ranks wait
        for it, so each can :meth:`restore` right after. With a ``tp_mesh``
        every rank calls it: the cut parameters and their moments are
        gathered to the single-device layout, which rank 0 writes."""
        mesh = self.aggregation.mesh or self.tp_mesh
        params = gather_params(self.model, export_params(self.model))
        opt_state = gather_optimizer_state(self.model, self.optimizer.state_dict())
        # a mesh of no group is one process playing a rank: nothing to wait for
        sync = mesh is not None and mesh.group is not None
        if mesh is not None and mesh.rank != 0:
            if sync:
                torch.distributed.barrier(group=mesh.group)
            return
        save_checkpoint(
            path, params,
            torch_state={"optimizer": opt_state, "generator": self.generator.get_state()},
            meta={"epoch": int(epoch), "seed": self.seed,
                  "model": type(self.model).__name__},
        )
        if sync:
            torch.distributed.barrier(group=mesh.group)

    def restore(self, path: str) -> int:
        """Load a checkpoint written by :meth:`save`, or the parameters of
        one written by the JAX package's ``save_checkpoint`` (which carries
        no torch state: the optimizer and generator then stay as they are).
        Under a ``tp_mesh`` the single-device layout is cut to this rank's
        blocks again. Returns the epoch to pass to ``fit(...,
        start_epoch=...)``."""
        params, state = load_checkpoint(path, export_params(self.model))
        load_jax_params(self.model, shard_params(self.model, params))
        if state is not None:
            self.optimizer.load_state_dict(apply_tp_state(self.model, state["optimizer"]))
            self.generator.set_state(state["generator"])
        self._restored = True
        self._drop_graphs()
        return int(load_meta(path).get("epoch", 0))

    @torch.no_grad()
    def predict_logits(self, g: Optional[TextGraph] = None) -> torch.Tensor:
        """Logits for all nodes (no dropout); a halo rank gathers every
        rank's rows."""
        adj, feats = (self._adj, self._feats) if g is None else self.prepare(g)
        logits = self.model(adj, feats, train=False)
        if self.aggregation.halo:
            logits = all_gather_rows(self.aggregation.mesh, logits)[:adj.n_nodes]
        return logits

    def evaluate(self, g: TextGraph, mask=None, n_classes: Optional[int] = None):
        """Test metrics over ``mask`` (default: the graph's test_mask)."""
        if n_classes is None:
            n_classes = int(np.max(np.asarray(g.y))) + 1
        mask = self._tensor(g.test_mask if mask is None else mask)
        y = self._tensor(g.y, torch.int64)
        pred = self.predict_logits(g).argmax(dim=-1)
        return {
            "accuracy": float(accuracy(pred, y, mask)),
            "f1_macro": float(macro_f1(pred, y, mask, n_classes)),
        }
