"""The comparison that decides ``correct``: the program's outputs against the
plain reference's, each number beside its limit.

The numbers (a cell compares those its ``limits/<cell>.json`` lists, with
the readings the limits were set from in PERF.md):

* ``edges_mismatch``: edges ``(src, dst)`` in one graph and not the other;
* ``edge_weight_gap``: the largest ``|w - w_ref|`` over the shared edges,
  against ``max(|w_ref|, median |w_ref|)``;
* ``ahat_gap``: the same over ``A_hat``'s edge and self-loop weights;
* ``loss_gap``: the largest relative gap of the first epochs' train and
  validation losses; ``loss1_gap``: the same over the first epoch alone;
* ``grad_gap``: the worst leaf's ``| ||g1|| - ||g1_ref|| |``, the first
  gradient's norms, against the larger of that leaf's reference norm and
  the median leaf's;
* ``update_gap``: the same for the norm of each leaf's change over the first
  steps; ``update_median_gap``: the median leaf's gap instead of the worst.
  Leaves whose reference gradient is under a thousandth of the median
  leaf's move by round-off alone and are left out of both;
* ``step_loss_gap``: for the step of the timed window that the reference
  takes from the program's own state, the largest relative gap of the
  validation loss before it and the step's loss; ``step_grad_gap``: that
  step's worst leaf gradient norm, as ``grad_gap``; ``step_unmoved``: the
  leaves the reference's gradient moves (as above) that the program's step
  left bit for bit unchanged.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

NUMBERS = ("edges_mismatch", "edge_weight_gap", "ahat_gap", "loss_gap", "loss1_gap",
           "grad_gap", "update_gap", "update_median_gap", "step_loss_gap", "step_grad_gap", "step_unmoved")


def _rel_gap(x: np.ndarray, ref: np.ndarray) -> float:
    if x.shape != ref.shape:
        return math.inf
    if not len(ref):
        return 0.0
    scale = np.maximum(np.abs(ref), np.median(np.abs(ref)))
    return float(np.max(np.abs(x.astype(np.float64) - ref) / scale))


def compare_graph(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: the program's ``src``, ``dst``, ``w``, ``n_vocab``, ``n_docs``,
    and ``norm_w`` / ``self_w`` of its operator; ``ref``: the reference's
    graph with ``norm_w`` / ``self_w``."""
    n_p = prog["n_vocab"] + prog["n_docs"]
    n_r = ref["n_vocab"] + ref["n_docs"]
    if n_p != n_r:
        return {"edges_mismatch": float(max(len(prog["src"]), len(ref["src"]))),
                "edge_weight_gap": math.inf, "ahat_gap": math.inf}
    kp = prog["src"] * n_p + prog["dst"]
    kr = ref["src"] * n_r + ref["dst"]
    shared, ip, ir = np.intersect1d(kp, kr, assume_unique=True, return_indices=True)
    mismatch = len(kp) + len(kr) - 2 * len(shared)
    return {
        "edges_mismatch": float(mismatch),
        "edge_weight_gap": _rel_gap(prog["w"][ip], ref["w"][ir].astype(np.float64)),
        "ahat_gap": max(_rel_gap(prog["norm_w"][ip], ref["norm_w"][ir]),
                        _rel_gap(prog["self_w"], ref["self_w"])),
    }


def _leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]):
    if not leaves:
        return [0.0]
    med = float(np.median([ref[k] for k in leaves]))
    return [abs(prog[k] - ref[k]) / max(ref[k], med) for k in leaves]


def _rel(prog, ref) -> float:
    p, r = np.array(prog, np.float64), np.array(ref, np.float64)
    return float(np.max(np.abs(p - r) / np.abs(r))) if p.shape == r.shape else math.inf


def _moving(grads: Dict[str, float]) -> list:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's."""
    med = float(np.median(list(grads.values())))
    return [k for k, g in grads.items() if g >= 1e-3 * med]


def compare_training(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog`` / ``ref``: ``loss`` and ``val_loss`` per epoch, ``grad1`` and
    ``delta`` per leaf."""
    moved = _moving(ref["grad1"])
    update = _leaf_gaps(prog["delta"], ref["delta"], moved)
    return {
        "loss_gap": _rel(prog["loss"] + prog["val_loss"], ref["loss"] + ref["val_loss"]),
        "loss1_gap": _rel(prog["loss"][:1] + prog["val_loss"][:1],
                          ref["loss"][:1] + ref["val_loss"][:1]),
        "grad_gap": max(_leaf_gaps(prog["grad1"], ref["grad1"], list(ref["grad1"]))),
        "update_gap": max(update),
        "update_median_gap": float(np.median(update)),
    }


def compare_step(prog: dict, ref) -> Dict[str, float]:
    """``prog`` / ``ref``: ``val_loss``, ``loss`` and ``grad`` per leaf of one
    step, and on the program's side ``moved`` per leaf (none where the
    control stands in its place); ``ref`` None where the program never
    reached the step."""
    if ref is None:
        return {"step_loss_gap": math.inf, "step_grad_gap": math.inf, "step_unmoved": math.inf}
    moved = prog.get("moved")
    return {
        "step_loss_gap": _rel([prog["val_loss"], prog["loss"]], [ref["val_loss"], ref["loss"]]),
        "step_grad_gap": max(_leaf_gaps(prog["grad"], ref["grad"], list(ref["grad"]))),
        "step_unmoved": float(sum(not moved.get(k, False) for k in _moving(ref["grad"])))
        if moved is not None else 0.0,
    }


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the limits name with its limit and whether it holds (a
    number that is not finite fails)."""
    return {k: {"value": values[k], "limit": lim,
                "ok": bool(math.isfinite(values[k]) and values[k] <= lim)}
            for k, lim in limits.items()}
