"""Per-label ensemble: one child classifier per parent class.

Port of the sequential path of ``pytextgcn_tpu/hierarchy/perlabel.py``
(the reference's perlabel_amazon.py + eval_perlabel.py, SURVEY.md §3.6):
for each parent class, mask the graph to that class's documents, relabel
its child labels contiguously, train a model on ``split_mask AND
class_mask``; at composed inference, route each test document to one child
model and map its local prediction back to the global label space. The
graph is built once; members swap labels and masks and share one operator
(``Trainer.share_adjacency``).

Routing: the reference routes by the **ground-truth** parent label
(eval_perlabel.py:73; its level-1 predictions are computed but never used);
that quirk is the default (``route='ground_truth'``), ``route='predicted'``
routes by ``parent_pred``.

The batched ensemble (``ep=True``, the JAX package's expert-parallel step
on one device): every member steps together, its parameters stacked
``[M, ...]`` and padded to the largest class count with zero weight
columns and a ``-1e9`` bias, whose logits get probability 0 and exactly
zero gradients. Where the JAX package vmaps the members' SpMMs, the
port applies ``A_hat`` once to the members' activations laid side by
side, ``[N, M * H]``: one CSR kernel launch of width M * H per
application instead of M of width H, the same function. Composed
inference runs all members in one such pass too. :class:`Ensemble` holds
that state: built once, it steps the members ``fit`` after ``fit``.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph
from ..models import EGCN, GCN, JumpingKnowledgeNetwork, export_params
from ..models.layers import dropout, stacked_bilstm
from ..ops.features import NodeFeatures
from ..ops.spmm import spmm
from ..parallel.sharded import Mesh, all_gather_rows
from ..train.checkpoint import save_checkpoint
from ..train.metrics import accuracy, macro_f1
from ..train.optim import resolve_optimizer
from ..train.profiling import span, stage
from ..train.trainer import Trainer

# padded class logits: exp() underflows to exactly 0 in f32, so padded
# columns get exactly zero gradients and never win an argmax
_PAD_BIAS = -1e9


def _member_label_arrays(g: TextGraph, y_child, y_parent, n_parents):
    """Per parent: (its child classes, node labels relabelled contiguously,
    node mask of its documents), as perlabel_amazon.py:93-110 builds them."""
    out = []
    for c in range(n_parents):
        doc_mask = y_parent == c
        classes = np.unique(y_child[doc_mask])
        local = np.searchsorted(classes, y_child)
        y_nodes = np.zeros(g.n_nodes, np.int32)
        y_nodes[g.n_vocab:][doc_mask] = local[doc_mask].astype(np.int32)
        node_mask = np.zeros(g.n_nodes, bool)
        node_mask[g.n_vocab:] = doc_mask
        out.append((classes, y_nodes, node_mask))
    return out


def train_per_label(
    g: TextGraph,
    y_child: np.ndarray,
    y_parent: np.ndarray,
    model_factory: Callable[[int, int], torch.nn.Module],
    lr: float = 0.05,
    epochs: int = 500,
    seed: int = 42,
    verbose: int = 0,
    save_dir: Optional[str] = None,
    trainer_kwargs: Optional[dict] = None,
    mesh=None,
    ep: bool = False,
):
    """Train one child-label classifier per parent class, one after the
    other, or, with ``ep`` (or a ``mesh``), all in one batched step (see
    the module docstring; GCN, EGCN or JK members of one shape). ``mesh``:
    a ``parallel.Mesh`` (``make_mesh(axis="ensemble")``) spreads the
    members over its ranks, one process a rank; the device count 1 (or an
    object with a one-device ``devices`` array) is the batched step in this
    process.

    Returns ``{"trainers": [...], "mapping": {parent: [global child ids]},
    "histories": [...]}``: the mapping holds, per parent class, the sorted
    global child labels in local-label order (the reference's LabelEncoder
    ``classes_``, class_mapping.json). With
    ``save_dir``, each member is checkpointed as ``lvl2-cat{c}`` (its
    parameters, meta ``{"parent", "classes"}``) beside
    ``class_mapping.json``.
    """
    if mesh is not None and not isinstance(mesh, Mesh):
        devices = getattr(mesh, "devices", None)
        n_dev = mesh if isinstance(mesh, int) else (
            None if devices is None else np.asarray(devices).size)
        if n_dev != 1:
            raise ValueError(
                f"mesh={mesh!r}: the ensemble spreads over the ranks of a parallel.Mesh "
                "(make_mesh(axis='ensemble') in each of its processes); a device count "
                "or a devices array of one runs the batched step here")
        mesh = None
        ep = True
    if ep or mesh is not None:
        ens = Ensemble(g, y_child, y_parent, model_factory, lr=lr, seed=seed,
                       trainer_kwargs=trainer_kwargs, mesh=mesh)
        return ens.finish(ens.fit(epochs, verbose=verbose), save_dir)
    trainer_kwargs = dict(trainer_kwargs or {})
    # the reference's per-label driver trains with PLAIN Adam, not amsgrad
    # (perlabel_amazon.py:124)
    if trainer_kwargs.get("optimizer") is None:
        trainer_kwargs["optimizer"] = "adam"
    y_child = np.asarray(y_child, np.int64)
    y_parent = np.asarray(y_parent, np.int64)
    n_parents = int(y_parent.max()) + 1

    trainers: List[Trainer] = []
    histories = []
    mapping: Dict[int, List[int]] = {}
    for c, (classes, y_nodes, node_mask) in enumerate(
            _member_label_arrays(g, y_child, y_parent, n_parents)):
        mapping[c] = classes.tolist()
        g_c = dataclasses.replace(
            g, y=y_nodes,
            train_mask=np.asarray(g.train_mask) & node_mask,
            val_mask=np.asarray(g.val_mask) & node_mask,
            test_mask=np.asarray(g.test_mask) & node_mask,
        )
        trainer = Trainer(model_factory(g_c.in_dim, len(classes)), lr=lr, seed=seed,
                          **trainer_kwargs)
        if trainers:
            # members differ only in labels and masks: one operator
            trainer.share_adjacency(trainers[0])
        histories.append(trainer.fit(g_c, epochs=epochs, n_classes=len(classes),
                                     verbose=verbose))
        trainers.append(trainer)
        if save_dir is not None:
            save_checkpoint(os.path.join(save_dir, f"lvl2-cat{c}"),
                            export_params(trainer.model),
                            meta={"parent": c, "classes": classes.tolist()})
    if save_dir is not None:
        with open(os.path.join(save_dir, "class_mapping.json"), "w") as f:
            json.dump({str(k): v for k, v in mapping.items()}, f)
    return {"trainers": trainers, "mapping": mapping, "histories": histories}


def _roles(model: torch.nn.Module) -> List[str]:
    """Each parameter's part in the stack, in ``parameters()`` order:
    'feature' for the weight the identity features multiply (stacked
    ``[in, M, d]``, so the members' feature products are one ``[in, M * d]``
    matrix), 'pad_w' / 'pad_b' for the class-count weight and bias (padded
    to the largest class count), 'plain' for the rest (stacked ``[M, ...]``)."""
    names = [n for n, _ in model.named_parameters()]
    if isinstance(model, EGCN):
        feature, head = "embed.w", f"layers.{len(model.layers) - 1}"
    elif isinstance(model, JumpingKnowledgeNetwork):
        feature, head = "layers.0.w", "head"
    else:
        feature, head = "layers.0.w", f"layers.{len(model.layers) - 1}"
    return ["feature" if n == feature else "pad_w" if n == f"{head}.w"
            else "pad_b" if n == f"{head}.b" else "plain" for n in names]


def _stack_members(models: List[torch.nn.Module], c_list: List[int],
                   device, c_max: Optional[int] = None) -> List[torch.Tensor]:
    """The members' parameters stacked in ``parameters()`` order, each as
    its role says (:func:`_roles`): the class-count weight padded with zero
    columns and its bias with ``_PAD_BIAS`` to ``c_max`` classes (default:
    the largest of ``c_list``)."""
    c_max = max(c_list) if c_max is None else c_max
    out = []
    for role, params in zip(_roles(models[0]), zip(*(m.parameters() for m in models))):
        rows = []
        for p, c in zip(params, c_list):
            p = p.detach()
            if role in ("pad_w", "pad_b") and c < c_max:
                p = torch.nn.functional.pad(p, (0, c_max - c),
                                            value=0.0 if role == "pad_w" else _PAD_BIAS)
            rows.append(p)
        out.append(torch.stack(rows, dim=1 if role == "feature" else 0).to(device)
                   .requires_grad_(True))
    return out


def _member(role: str, stacked: torch.Tensor, i: int) -> torch.Tensor:
    """Member ``i``'s slice of a stacked parameter (still padded)."""
    return stacked[:, i] if role == "feature" else stacked[i]


def _products(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each member's ``h[:, m] @ w[m]``: ``[N, M, d] x [M, d, e] -> [N, M, e]``.
    Narrow ``d``: one product against the block-diagonal weights (zeros off
    the blocks add nothing), since a batched product of M skinny
    ``[N, d] @ [d, e]`` runs far slower on the card, its backward most;
    wide ``d`` (EGCN's 2000-wide embedding): one batched product."""
    n, m_count, d = h.shape
    if d >= 512:
        return torch.bmm(h.transpose(0, 1), w).transpose(0, 1)
    return (h.reshape(n, m_count * d) @ torch.block_diag(*w.unbind(0))).reshape(n, m_count, -1)


def _member_dropout(h: torch.Tensor, model, train: bool, generators,
                    widths: Optional[List[int]] = None) -> torch.Tensor:
    """Dropout on ``[N, M, d]``, member m's mask drawn from ``generators[m]``
    in the shape its own model draws: ``widths[m]`` columns when given (the
    padded logits keep their ``_PAD_BIAS`` columns, undropped)."""
    if not (train and model.dropout):
        return h
    cols = []
    for i in range(h.shape[1]):
        c = h.shape[2] if widths is None else widths[i]
        hi = dropout(h[:, i, :c], model.dropout, True, generators[i])
        cols.append(torch.cat([hi, h[:, i, c:]], dim=-1) if c < h.shape[2] else hi)
    return torch.stack(cols, dim=1)


def _stacked_logits(params: List[torch.Tensor], model: torch.nn.Module, adj,
                    feats: NodeFeatures, train: bool = False, generators=None,
                    c_list: Optional[List[int]] = None) -> torch.Tensor:
    """``[N, M, C_max]`` logits of M stacked members of ``model``'s
    architecture (GCN, EGCN or the JK network): each aggregation is one SpMM
    over ``[N, M * width]``. Member m's dropout masks come from
    ``generators[m]`` in the order and shapes its own model draws them
    (``c_list``: the members' class counts, for EGCN's dropout on the
    logits)."""
    p = dict(zip([n for n, _ in model.named_parameters()], params))
    feature = next(k for k, r in zip(p, _roles(model)) if r == "feature")
    w0 = p[feature]  # [in, M, d]
    m_count = w0.shape[1]

    def aggregate(xw):  # [N, M, d] -> [N, M * d] -> A_hat @ . -> [N, M, d]
        n, _, d = xw.shape
        return spmm(adj, xw.reshape(n, m_count * d)).reshape(n, m_count, d)

    xw = feats.matmul(w0.reshape(w0.shape[0], -1)).reshape(-1, m_count, w0.shape[2])
    layers = [(p[f"layers.{i}.w"], p[f"layers.{i}.b"]) for i in range(len(model.layers))]
    if isinstance(model, EGCN):
        h = _member_dropout(torch.selu(xw + p["embed.b"]), model, train, generators)
        for i, (w, b) in enumerate(layers):
            h = aggregate(_products(h, w)) + b
            if model.activation is not None:
                h = model.activation(h)
            last = i == len(layers) - 1
            h = _member_dropout(h, model, train, generators, c_list if last else None)
        return h
    if isinstance(model, JumpingKnowledgeNetwork):
        h = aggregate(xw) + layers[0][1]
        acts = [_member_dropout(h, model, train, generators)]
        for w, b in layers[1:]:
            acts.append(_member_dropout(aggregate(_products(acts[-1], w)) + b, model, train,
                                        generators))
        xs = torch.stack(acts, dim=2).transpose(0, 1)  # [M, N, L, C]
        lstm = [p[f"lstm.{stem}{sfx}"] for sfx in ("", "_reverse")
                for stem in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")]
        alpha = stacked_bilstm(xs, lstm[:4], lstm[4:])  # [M, N, L, 2H]
        score = torch.softmax(torch.einsum("mnlh,mh->mnl", alpha, p["att.w"][..., 0])
                              + p["att.b"][:, None, None, 0], dim=-1)  # [M, N, L]
        h = (xs * score[..., None]).sum(dim=2).transpose(0, 1)  # [N, M, C]
        h = _member_dropout(model.activation(h), model, train, generators)
        return _products(h, p["head.w"]) + p["head.b"]
    h = aggregate(xw) + layers[0][1]
    for w, b in layers[1:]:
        if model.activation is not None:
            h = model.activation(h)
        h = aggregate(_products(_member_dropout(h, model, train, generators), w)) + b
    return h


def ep_train_step(params: List[torch.Tensor], opt: torch.optim.Optimizer, model, adj,
                  feats: NodeFeatures, y: torch.Tensor, mask: torch.Tensor,
                  generators, c_list: Optional[List[int]] = None) -> torch.Tensor:
    """One batched train step of the stacked members: forward, each
    member's masked cross-entropy (``y``, ``mask``: ``[N, M]``), one
    backward pass of their sum, one optimizer step. Returns the ``[M]``
    losses."""
    opt.zero_grad(set_to_none=True)
    logits = _stacked_logits(params, model, adj, feats, train=True, generators=generators,
                             c_list=c_list)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, y[..., None])[..., 0]
    losses = (nll * mask).sum(0) / mask.sum(0).clamp(min=1.0)  # as masked_cross_entropy
    losses.sum().backward()
    opt.step()
    return losses.detach()


def _architecture(models) -> Optional[tuple]:
    """The shape of the members' model apart from its class count, or None
    when they differ or are not GCNs, EGCNs or JK networks of one shape (no
    batched pass then)."""
    def key(m):
        if type(m) not in (GCN, EGCN, JumpingKnowledgeNetwork):
            return None
        return (type(m), m.in_dim, m.n_gcn, m.n_hidden, m.dropout, m.activation,
                getattr(m, "embedding_dim", None))

    keys = {key(m) for m in models}
    return keys.pop() if len(keys) == 1 else None


def _member_dim(role: str) -> int:
    """The dimension along which a stacked parameter holds its members."""
    return 1 if role == "feature" else 0


def _gather_members(mesh: Optional[Mesh], t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block of members of ``t`` along ``dim``, in rank order
    (``t`` itself without a mesh)."""
    if mesh is None:
        return t
    return all_gather_rows(mesh, t.movedim(dim, 0)).movedim(0, dim)


class Ensemble:
    """The batched ensemble (``train_per_label(ep=True)``, the JAX package's
    ``_train_per_label_ep``) as a resumable trainer: the set-up runs once
    (the members' labels and masks, their models from ``model_factory``,
    their Trainers and generators, one shared operator, the stacked and
    padded parameters and one optimizer over them), then :meth:`fit` steps
    every member on that state as often as it is called, and :meth:`finish`
    hands each member's state to its Trainer.

    Each member is initialized by ``model_factory`` in the sequential path's
    order, draws its dropout from the generator its sequential Trainer would
    use, and its masked cross-entropy is summed with the others' before one
    backward pass, so the trajectory is the sequential one's. One optimizer
    over the stacked parameters equals one per member: Adam is elementwise
    and every member steps on every step.

    With a ``mesh`` of D ranks the members are padded to ``m_pad = ceil(M /
    D) * D`` and rank r steps members ``[r * m_pad / D, (r+1) * m_pad / D)``
    (``mine``) on its device (the block ``P(axis)`` gives a JAX rank), dummies
    past M with an all-false mask; the operator's hybrid cost model is priced
    at that block (``hybrid_batch``)."""

    steps = 0  # batched train steps taken in this process, by every ensemble

    def __init__(self, g: TextGraph, y_child, y_parent, model_factory, *, lr: float = 0.05,
                 seed: int = 42, trainer_kwargs: Optional[dict] = None,
                 mesh: Optional[Mesh] = None):
        trainer_kwargs = dict(trainer_kwargs or {})
        if trainer_kwargs.get("optimizer") is None:
            trainer_kwargs["optimizer"] = "adam"  # perlabel_amazon.py:124
        if mesh is not None:
            asked = trainer_kwargs.get("device")
            if asked is not None and torch.device(asked) != mesh.device:
                raise ValueError(f"device {asked} is not the mesh's {mesh.device}")
            trainer_kwargs["device"] = mesh.device
        y_child = np.asarray(y_child, np.int64)
        y_parent = np.asarray(y_parent, np.int64)
        members = _member_label_arrays(g, y_child, y_parent, int(y_parent.max()) + 1)
        self.g, self.mesh = g, mesh
        self.mapping = {c: classes.tolist() for c, (classes, _, _) in enumerate(members)}
        self.c_list = [len(classes) for classes, _, _ in members]
        models = [model_factory(g.in_dim, c) for c in self.c_list]
        if _architecture(models) is None:
            raise ValueError("the batched ensemble (--train-ep) stacks members of one "
                             "architecture: GCNs, EGCNs or JK networks")
        self.trainers = [Trainer(m, lr=lr, seed=seed, **trainer_kwargs) for m in models]
        lead = self.trainers[0]
        dev = lead.device
        self.model, self.roles = models[0], _roles(models[0])
        self.names = [n for n, _ in self.model.named_parameters()]
        world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
        self.m_local = -(-len(models) // world)
        self.mine = [i for i in range(rank * self.m_local, (rank + 1) * self.m_local)
                     if i < len(models)]
        n_dummy = self.m_local - len(self.mine)
        self.adj = lead.aggregation.operator(g, dev, h_hint=models[0].n_hidden,
                                             batch=self.m_local)
        self.feats = NodeFeatures.from_graph(g, device=dev)
        for t in self.trainers:  # the members adopt the operator
            t.adopt(self.adj, g, self.feats)

        # this rank's block; a dummy repeats member 0 and trains on no row
        self.c_local = [self.c_list[i] for i in self.mine] + [self.c_list[0]] * n_dummy
        with stage("ensemble.stack"):
            self.params = _stack_members([models[i] for i in self.mine] + [models[0]] * n_dummy,
                                         self.c_local, dev, c_max=max(self.c_list))
        self.optimizer = resolve_optimizer(trainer_kwargs["optimizer"], self.params, lr)
        no_rows = np.zeros(g.n_nodes, bool)
        self.y = torch.as_tensor(np.stack([members[i][1] for i in self.mine]
                                          + [np.zeros(g.n_nodes, np.int32)] * n_dummy, 1),
                                 dtype=torch.int64, device=dev)  # [N, m_local]
        self.mask = torch.as_tensor(
            np.stack([np.asarray(g.train_mask) & members[i][2] for i in self.mine]
                     + [no_rows] * n_dummy, 1), device=dev).float()
        self.generators = [self.trainers[i].generator for i in self.mine] + [
            torch.Generator(device=dev).manual_seed(0) for _ in range(n_dummy)]
        self.debug_checks = lead.debug_checks
        self.epoch = 0  # the steps taken over every fit

    def step(self) -> torch.Tensor:
        """One batched train step of this rank's members: the ``[m_local]``
        losses, on the device."""
        with span("ensemble.step"):
            losses = ep_train_step(self.params, self.optimizer, self.model, self.adj,
                                   self.feats, self.y, self.mask, self.generators, self.c_local)
        Ensemble.steps += 1
        if self.debug_checks:
            Trainer._check_finite(self.epoch, [("member losses", losses)] + [
                (f"stacked gradient {j}", q.grad) for j, q in enumerate(self.params)] + [
                (f"stacked parameter {j}", q) for j, q in enumerate(self.params)])
        self.epoch += 1
        return losses

    def fit(self, epochs: int, log_fn: Optional[Callable[[str], None]] = None,
            verbose: int = 0) -> List[List[float]]:
        """Step every member ``epochs`` times, continuing the state of the
        last call; returns each epoch's member losses, ``[epochs][m_local]``
        (a dummy's column after the members). With ``log_fn``, each epoch
        reads its ``[m_local]`` losses once (``tolist()``) and calls ``log_fn``
        with ``"[<epoch>] member losses: ..."``, epochs counted over every
        call; without, nothing is read before the call's end. ``verbose``:
        print the losses every 50 epochs."""
        rows = []
        for _ in range(epochs):
            losses = self.step()
            row = losses
            if log_fn is not None:
                with span("ensemble.host_read"):
                    row = losses.tolist()
                log_fn(f"[{self.epoch}] member losses: "
                       + ", ".join(f"{v:.4f}" for v in row[:len(self.mine)]))
            rows.append(row)
            if verbose > 0 and self.epoch % 50 == 0:
                print(f"[EP {self.epoch}] member losses: "
                      f"{losses[:len(self.mine)].cpu().numpy()}")
        if log_fn is None and rows:
            rows = torch.stack(rows).tolist()
        return rows

    def member_params(self, stacked: Optional[List[torch.Tensor]] = None
                      ) -> List[Dict[str, torch.Tensor]]:
        """This rank's members' leaves by name, each in its own model's shape:
        views of ``stacked`` (default: the stacked parameters; also their
        gradients or a copy)."""
        stacked = self.params if stacked is None else stacked
        return [{n: _member(r, q, i)[..., :c] if r in ("pad_w", "pad_b") else _member(r, q, i)
                 for n, r, q in zip(self.names, self.roles, stacked)}
                for i, c in enumerate(self.c_local[:len(self.mine)])]

    def logits(self) -> torch.Tensor:
        """Composed inference's batched forward on the ensemble's own state
        (no restacking): this rank's members' document logits ``[n_docs,
        m_local, c_max]``, -inf past each member's class count."""
        return _document_logits(self.params, self.model, self.adj, self.feats, self.g.n_vocab,
                                self.c_local)

    def finish(self, rows: List[List[float]], save_dir: Optional[str] = None) -> dict:
        """Hand every member's parameters, optimizer state and dropout
        generator to its Trainer, ready to refit (over a mesh: gathered from
        the rank that stepped it, on every rank; rank 0 alone writes
        ``save_dir``), and return :func:`train_per_label`'s result with
        ``rows`` (:meth:`fit`'s) as the histories."""
        mesh, roles, dev = self.mesh, self.roles, self.trainers[0].device
        world, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
        with torch.no_grad():
            stacked = [_gather_members(mesh, p.detach(), _member_dim(r))
                       for p, r in zip(self.params, roles)]
            state = {j: {k: v if v.dim() == 0
                         else _gather_members(mesh, v, _member_dim(roles[j]))
                         for k, v in st.items()}
                     for j, st in self.optimizer.state_dict()["state"].items()}
            loss_rows = torch.tensor(rows, dtype=torch.float32, device=dev).reshape(
                -1, self.m_local)
            loss_rows = _gather_members(mesh, loss_rows, 1).cpu()  # [epochs, m_pad]
            for i, t in enumerate(self.trainers):
                member_state = {}
                for j, (p, q) in enumerate(zip(t.model.parameters(), stacked)):
                    # the padded class columns cut off: the member's own shape
                    p.copy_(_member(roles[j], q, i)[..., :p.shape[-1]])
                    member_state[j] = {
                        k: v.clone() if v.dim() == 0
                        else _member(roles[j], v, i)[..., :p.shape[-1]].clone()
                        for k, v in state[j].items()}
                sd = t.optimizer.state_dict()
                t.optimizer.load_state_dict({"state": member_state,
                                             "param_groups": sd["param_groups"]})
        if world > 1:  # each member's dropout stream from the rank that stepped it
            gen_states = [None] * world
            torch.distributed.all_gather_object(
                gen_states, [self.trainers[i].generator.get_state() for i in self.mine],
                group=mesh.group)
            for r, states in enumerate(gen_states):
                for i, st in zip(range(r * self.m_local, len(self.trainers)), states):
                    self.trainers[i].generator.set_state(st)
        if save_dir is not None and rank == 0:
            for c, t in enumerate(self.trainers):
                save_checkpoint(os.path.join(save_dir, f"lvl2-cat{c}"), export_params(t.model),
                                meta={"parent": c, "classes": self.mapping[c]})
            with open(os.path.join(save_dir, "class_mapping.json"), "w") as f:
                json.dump({str(k): v for k, v in self.mapping.items()}, f)
        if save_dir is not None and world > 1:  # the files are there when a rank returns
            torch.distributed.barrier(group=mesh.group)
        histories = [[{"loss": float(v)} for v in loss_rows[:, i].tolist()]
                     for i in range(len(self.trainers))]
        return {"trainers": self.trainers, "mapping": self.mapping, "histories": histories}


def _document_logits(params: List[torch.Tensor], model: torch.nn.Module, adj,
                     feats: NodeFeatures, n_vocab: int, c_list: List[int]) -> torch.Tensor:
    """The stacked members' document logits, ``[n_docs, M, C_max]``, in one
    forward pass, -inf past each member's class count (never an argmax)."""
    with span("ensemble.eval"), torch.no_grad():
        logits = _stacked_logits(params, model, adj, feats)[n_vocab:]
        col = torch.arange(logits.shape[-1], device=logits.device)
        c = torch.as_tensor(c_list, device=logits.device)
        return torch.where(col < c[:, None], logits, -torch.inf)


def _batched_member_logits(g_eval: TextGraph, trainers: List[Trainer],
                           c_list: List[int]) -> Optional[torch.Tensor]:
    """Every member's document logits in one forward pass of the stacked,
    padded members (:func:`_document_logits`), or None when the members do
    not stack (the member loop then runs)."""
    models = [t.model for t in trainers]
    if len(trainers) < 2 or _architecture(models) is None:
        return None
    adj, feats = trainers[0].prepare(g_eval)
    with torch.no_grad():
        params = _stack_members(models, c_list, trainers[0].device)
    return _document_logits(params, models[0], adj, feats, g_eval.n_vocab, c_list)


def _batched_member_preds(g_eval: TextGraph, trainers: List[Trainer],
                          c_list: List[int]) -> Optional[np.ndarray]:
    """Every member's document predictions (padded columns never win):
    ``[M, n_docs]``, or None when the members do not stack."""
    logits = _batched_member_logits(g_eval, trainers, c_list)
    return None if logits is None else logits.argmax(dim=-1).t().cpu().numpy()


def eval_per_label(
    g: TextGraph,
    y_child: np.ndarray,
    y_parent: np.ndarray,
    trainers: Union[List[Trainer], "Ensemble"],
    mapping: Dict[int, List[int]],
    parent_pred: Optional[np.ndarray] = None,
    route: str = "ground_truth",
):
    """Composed hierarchical inference (eval_perlabel.py:57-85): every
    member in one batched forward pass when they stack (GCNs of one
    architecture), else one member at a time; the two give the same
    predictions. ``trainers``: the members' Trainers, or the
    :class:`Ensemble` that trains them (one device), whose stacked state the
    pass reads as it stands, on the graph the ensemble was built on.

    ``route='ground_truth'`` routes each test document by its true parent
    class, as the reference does; ``route='predicted'`` by ``parent_pred``
    (per-document parent predictions, e.g. of a level-1 flat model). A
    document no member takes stays -1 and scores as a label of its own.
    Besides the scores and predictions, ``"logits"`` holds the batched
    pass's ``[n_docs, M, C_max]`` document logits (None for the member loop).
    """
    if route not in ("ground_truth", "predicted"):
        raise ValueError(f"unknown route {route!r}")
    y_child = np.asarray(y_child, np.int64)
    y_parent = np.asarray(y_parent, np.int64)
    test_docs = np.asarray(g.test_mask)[g.n_vocab:]
    if route == "predicted":
        if parent_pred is None:
            raise ValueError("route='predicted' needs parent_pred")
        router = np.asarray(parent_pred, np.int64)
    else:
        router = y_parent

    # child labels on every document
    y_nodes = np.zeros(g.n_nodes, np.int32)
    y_nodes[g.n_vocab:] = y_child.astype(np.int32)
    g_eval = dataclasses.replace(g, y=y_nodes)

    predictions = np.full(len(y_child), -1, np.int64)
    c_list = [len(mapping[c]) for c in range(len(mapping))]
    if isinstance(trainers, Ensemble):
        if len(trainers.mine) != len(c_list):
            raise ValueError("an ensemble over ranks holds a block of the members: "
                             "evaluate the Trainers that Ensemble.finish returns")
        logits = trainers.logits()
    else:
        logits = _batched_member_logits(g_eval, trainers, c_list)
    preds_all = None if logits is None else logits.argmax(dim=-1).t().cpu().numpy()
    for c in range(len(c_list)):
        sel = (router == c) & test_docs
        if not sel.any():
            continue
        if preds_all is not None:
            local_pred = preds_all[c][sel]
        else:
            member = trainers[c].predict_logits(g_eval)[g.n_vocab:]
            local_pred = member.argmax(dim=-1).cpu().numpy()[sel]
        predictions[sel] = np.asarray(mapping[c], np.int64)[local_pred]

    # shift by 1 so an unrouted -1 becomes its own (always wrong) label,
    # as sklearn scores the reference's init value of -1
    yt = torch.as_tensor(y_child[test_docs] + 1)
    pt = torch.as_tensor(predictions[test_docs] + 1)
    n_classes = int(max(y_child.max(), predictions.max())) + 2
    m = torch.ones(yt.shape[0], dtype=torch.bool)
    return {
        "accuracy": float(accuracy(pt, yt, m)),
        "f1_macro": float(macro_f1(pt, yt, m, n_classes)),
        "predictions": predictions,
        "logits": logits,
    }
