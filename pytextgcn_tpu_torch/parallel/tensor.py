"""Tensor parallelism for the wide EGCN embedding.

Port of ``pytextgcn_tpu/parallel/tensor.py``. EGCN puts a ``Linear(in,
2000)`` embedding in front of its GCN stack; with identity features its
weight is ``[N, 2000]``, the largest tensor of any model here, with two
Adam moments (three under amsgrad) beside it. Over the ranks of a mesh
(axis ``'model'``, ``make_mesh(axis="model")``) rank ``r`` holds

* ``embed.w[:, cols_r]`` and ``embed.b[cols_r]``: a block of the
  embedding's columns, so SELU and dropout run on its own columns;
* ``layers[0].w[cols_r, :]``: the rows of the first GCN weight that meet
  those columns, so the first contraction is a local product and one
  ``all_reduce`` (whose output is replicated, so its backward passes the
  gradient through unchanged);

and everything else whole. JAX lays this out with GSPMD shardings; here
each rank's model holds its blocks as its parameters, so its optimizer
state follows them (each rank's Adam runs over its own tensors).

Beside a graph mesh over the same ranks (the trainer's ``mesh``) the
embedding still runs over every row: the first contraction's
``all_reduce`` gives ``[N, hidden]`` on every rank, which 'allgather'
aggregates as a replicated activation, and from which the halo and the
sharded hybrid take the rank's rows (:meth:`TensorParallel.reduce_rows`,
whose backward all-gathers the ranks' row gradients, so each rank's
blocks get the gradient of every row).

Dropout on the embedding draws the full-width mask and keeps this rank's
columns (``models/layers.py::dropout``), so every rank seeded alike draws
the single-device masks. Checkpoints keep the single-device layout:
:func:`gather_params` / :func:`gather_optimizer_state` assemble it,
:func:`shard_params` / :func:`apply_tp_state` cut it again.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from .sharded import Mesh, all_gather_rows, all_reduce_sum, local_block

# parameter -> the dimension its blocks cut (JAX: P(None, axis), P(axis),
# P(axis, None)) and its path in the JAX parameter tree
TP_LEAVES = {"embed.w": (1, ("embed", "w")), "embed.b": (0, ("embed", "b")),
             "layers.0.w": (0, ("layers", 0, "w"))}


@dataclasses.dataclass
class TensorParallel:
    """A model's tensor-parallel layout: the mesh and this rank's block
    ``[lo, lo + width / D)`` of the embedding's ``width`` columns."""

    mesh: Mesh
    width: int
    lo: int

    @property
    def size(self) -> int:
        return self.width // self.mesh.world_size

    @property
    def cols(self) -> Tuple[int, int]:
        """``(width, lo)``: the dropout's column block
        (``models/layers.py::dropout``)."""
        return self.width, self.lo

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The ranks' partial products summed; the gradient passes
        through."""
        return _AllReduce.apply(t, self.mesh)

    def reduce_rows(self, t: torch.Tensor, rows_per: int) -> torch.Tensor:
        """The ranks' partial products ``[N, H]`` summed, then this rank's
        ``rows_per`` rows (zero past N) for a row-sharded operator: each
        rank's rows enter only its own loss terms, so the backward gathers
        every rank's row gradient to the whole ``[N, H]`` one."""
        return _ReduceRows.apply(t, self.mesh, rows_per)


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
        return all_reduce_sum(mesh, t.contiguous().clone())

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _ReduceRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t: torch.Tensor, mesh: Mesh, rows_per: int) -> torch.Tensor:
        ctx.mesh, ctx.n = mesh, t.shape[0]
        return local_block(mesh, all_reduce_sum(mesh, t.contiguous().clone()), rows_per)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return all_gather_rows(ctx.mesh, g)[:ctx.n], None, None


def tp_param_shardings(model: nn.Module) -> Dict[str, Optional[int]]:
    """Each parameter's name and the dimension its blocks cut (None:
    whole on every rank). Models without an ``embed`` (GCN, JK) hold
    everything whole."""
    has_embed = hasattr(model, "embed")
    return {name: TP_LEAVES[name][0] if has_embed and name in TP_LEAVES else None
            for name, _ in model.named_parameters()}


def _block(t, dim: int, lo: int, size: int):
    return t[:, lo:lo + size] if dim == 1 else t[lo:lo + size]


def apply_tp(model: nn.Module, mesh: Mesh) -> nn.Module:
    """Cut ``model``'s parameters to this rank's blocks, in place, and set
    ``model.tp``. Raises when the ranks do not divide the embedding's
    width. Build the optimizer afterwards, over the cut parameters."""
    if not hasattr(model, "embed"):
        return model
    width, world = model.embed.w.shape[1], mesh.world_size
    if width % world:
        raise ValueError(
            f"tensor parallelism over {world} ranks: the embedding width {width} does not "
            "split evenly; uneven column blocks are not ported (ROADMAP.md §1)")
    tp = TensorParallel(mesh, width, mesh.rank * (width // world))
    for name, dim in tp_param_shardings(model).items():
        if dim is None:
            continue
        owner, leaf = _owner(model, name)
        block = _block(getattr(owner, leaf).detach(), dim, tp.lo, tp.size)
        setattr(owner, leaf, nn.Parameter(block.contiguous()))
    model.tp = tp
    return model


def _owner(model: nn.Module, name: str):
    *path, leaf = name.split(".")
    owner = model
    for p in path:
        owner = getattr(owner, p) if not p.isdigit() else owner[int(p)]
    return owner, leaf


def _gather(mesh: Mesh, t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's block of ``t``, concatenated along ``dim``."""
    if mesh.world_size == 1 and mesh.group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(mesh.world_size)]
    dist.all_gather(parts, t, group=mesh.group)
    return torch.cat(parts, dim)


def _leaf_of(tree, path):
    for p in path[:-1]:
        tree = tree[p]
    return tree, path[-1]


def gather_params(model: nn.Module, params: Dict[str, Any]) -> Dict[str, Any]:
    """The JAX parameter tree ``params`` (``export_params(model)``) with the
    cut parameters gathered to their full shapes: a collective every rank
    calls."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return params
    for dim, path in TP_LEAVES.values():
        owner, key = _leaf_of(params, path)
        full = _gather(tp.mesh, torch.from_numpy(np.ascontiguousarray(owner[key])).to(
            tp.mesh.device), dim)
        owner[key] = full.cpu().numpy()
    return params


def shard_params(model: nn.Module, params: Dict[str, Any]) -> Dict[str, Any]:
    """A single-device JAX parameter tree cut to this rank's blocks (the
    inverse of :func:`gather_params`)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return params
    for dim, path in TP_LEAVES.values():
        owner, key = _leaf_of(params, path)
        owner[key] = np.ascontiguousarray(_block(np.asarray(owner[key]), dim, tp.lo, tp.size))
    return params


def _state_dims(model: nn.Module) -> Dict[int, int]:
    """Optimizer state index (the parameter's position in
    ``model.parameters()``) -> the dimension its blocks cut."""
    dims = tp_param_shardings(model)
    return {i: dims[name] for i, (name, _) in enumerate(model.named_parameters())
            if dims[name] is not None}


def _map_state(model: nn.Module, state: Dict[str, Any], fn) -> Dict[str, Any]:
    """``state`` with ``fn(tensor, dim)`` applied to each moment of a cut
    parameter; new dicts throughout (``Optimizer.state_dict`` hands out the
    live per-parameter state)."""
    per_param = dict(state["state"])
    for i, dim in _state_dims(model).items():
        if i in per_param:
            per_param[i] = {key: fn(t, dim) if torch.is_tensor(t) and t.dim() > dim else t
                            for key, t in per_param[i].items()}
    return {**state, "state": per_param}


def gather_optimizer_state(model: nn.Module, state: Dict[str, Any]) -> Dict[str, Any]:
    """An optimizer ``state_dict`` with the cut parameters' moments
    gathered to their full shapes (a collective every rank calls)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return state
    return _map_state(model, state, lambda t, dim: _gather(tp.mesh, t, dim))


def apply_tp_state(model: nn.Module, state: Dict[str, Any]) -> Dict[str, Any]:
    """A single-device optimizer ``state_dict`` cut to this rank's blocks,
    matched to the parameters by position (the port's
    ``apply_tp_state``)."""
    tp = getattr(model, "tp", None)
    if tp is None:
        return state
    return _map_state(model, state, lambda t, dim: _block(t, dim, tp.lo, tp.size).contiguous())
