"""Loop ``perlabel``: the per-label protocol's batched ensemble, the port's
``hierarchy/perlabel.py::Ensemble`` (what ``train_per_label(ep=True)`` and
``experiments/perlabel.py --train-ep true`` run): ``Ensemble.fit(
<epochs_per_fit>, log_fn)`` fit after fit on one ensemble, each fit followed
by composed inference over the test documents (``eval_per_label`` on the
ensemble, routed by ``route``), as ``experiments/perlabel.py::run`` follows
training with it.

Inputs, from ``--seed``: the members are the corpus's coarse level (Cat1),
whose labels are the seeded corpus's own level labels
(``corpus.protocol_corpus``, read again here); their children are the
graph's labels (Cat2). Each member's initial parameters, and the seed of its
dropout generator, come from ``benchmark/models/perlabel.py``: the port's
members, seeded alike, would each draw the same masks, where the reference
draws every member's masks from torch's one global stream.

Set-up: the ensemble (timed whole as ``ensemble_build_s``: its models,
Trainers, operator and stacking; its operator, ``NormAdj.from_graph``, as
``plan_build_s``, from the operator's stage records), then the traffic's
``first_steps`` epochs through ``fit`` itself (one call of one epoch, then
one of the rest), which also build the kernels on a checkout's first run.

Window: fit and inference again and again. ``log_fn`` stamps every epoch's
end (after the epoch's one read of the member losses) and stops the window
at the first epoch end past the deadline, once the first fit and its
inference have returned. An epoch is one batched step of every member and
that read; the inference, once a fit, falls into the next fit's first epoch.

Compared with the reference (``benchmark/reference/perlabel.py``, float64,
member by member), under ``check.py``'s names; member leaves are named
``m<i>.<leaf>``:

* ``loss_gap``: every member's loss over the set-up's epochs, each against
  the larger of its reference value and the median one (a member of one
  class reads 0 on both sides); ``loss1_gap``: the first epoch's;
* ``grad_gap``: each member leaf's first gradient norm, read from ``.grad``
  after the step, as the optimizer got it;
* ``update_gap`` / ``update_median_gap``: each member leaf's change over the
  set-up's epochs;
* ``step_loss_gap``: the window's numbers from the program's own state, the
  larger of two. At an epoch ``k`` of the window's first fit drawn from the
  seed (``1 <= k <= check_within``) the stacked parameters, cut into the
  members', and every member's generator state are copied; the reference
  takes them and gives step ``k + 1``'s member losses, which the program's
  history gives (``step_member_loss_gap``, as ``loss_gap``). And after the
  first fit, the logits of composed inference at the routed test documents,
  from the final parameters (copied then), as ``loss_gap`` compares losses
  (``routed_logit_gap``);
* ``step_grad_gap`` / ``step_unmoved``: step ``k + 1``'s gradient norms, and
  the leaves the reference's gradient moves that the step left unchanged.
"""

from __future__ import annotations

import functools
import json
import math
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from benchmark import check, corpus, program
from benchmark.loops.fit import Epochs, window
from benchmark.models import perlabel as counts
from benchmark.reference import perlabel as ref_perlabel
from pytextgcn_tpu_torch.config import ModelConfig, make_model
from pytextgcn_tpu_torch.hierarchy.perlabel import Ensemble, eval_per_label
from pytextgcn_tpu_torch.train import profiling


@functools.lru_cache(maxsize=1)
def _levels(corpus_json: str, n_docs: int, seed: int):
    _, level_labels, _, _ = corpus.protocol_corpus(json.loads(corpus_json), n_docs, seed)
    return level_labels[0], level_labels[-1]


def labels(cell, seed: int, n_docs: int):
    """``(y_parent, y_child)`` per document: the seeded corpus's coarsest and
    finest level labels (the harness built the graph from the same call)."""
    data = cell.config["data"]
    return _levels(json.dumps(data["corpus"], sort_keys=True), n_docs, seed)


def member_factory(model: dict, params: List[Dict[str, torch.Tensor]], seed: int,
                   device: torch.device) -> Callable:
    """``model_factory`` for the ensemble: the configuration's model through
    the port's ``make_model`` (every key of ``model`` but ``kind`` passed to
    ``ModelConfig``), drawn on the device, then set to the next member's
    ``params``."""
    m = dict(model)
    mcfg = ModelConfig(model=m.pop("kind"), **m)
    todo = iter(params)

    def make(d_in: int, d_out: int):
        with torch.device(device):
            made = make_model(mcfg, d_in, d_out, torch.Generator(device=device).manual_seed(seed))
        values = next(todo)
        with torch.no_grad():
            named = dict(made.named_parameters())
            if {k: tuple(v.shape) for k, v in named.items()} != {
                    k: tuple(v.shape) for k, v in values.items()}:
                raise ValueError(f"parameters {sorted(named)} != {sorted(values)}")
            for name, value in values.items():
                named[name].copy_(value)
        return made

    return make


def norms(views: List[Dict[str, torch.Tensor]]) -> Dict[str, torch.Tensor]:
    """Each member leaf's norm (``m<i>.<leaf>``), device scalars."""
    return {f"m{i}.{k}": v.detach().double().norm() for i, d in enumerate(views)
            for k, v in d.items()}


def read(values: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v) for k, v in values.items()}


def routed(logits: torch.Tensor, rows: List[np.ndarray], c_list: List[int]) -> torch.Tensor:
    """Member ``i``'s logits at its routed documents ``rows[i]``, its own
    class count wide, members in order, flattened (on the device)."""
    parts = [logits[torch.as_tensor(r, device=logits.device), i, :c].reshape(-1)
             for i, (r, c) in enumerate(zip(rows, c_list))]
    return torch.cat(parts)


class WindowStep:
    """At window epoch ``k``: copies the members' parameters and generator
    states; at ``k + 1``: the step's gradient norms (``.grad`` after the
    step) and which leaves it changed."""

    def __init__(self, ens: Ensemble, k: int):
        self.ens, self.k = ens, k
        self.params: Optional[List[Dict[str, torch.Tensor]]] = None
        self.gen_states = None
        self.grad: Dict[str, torch.Tensor] = {}
        self.moved: Dict[str, torch.Tensor] = {}

    def __call__(self, n: int) -> None:
        if n == self.k:
            self.params = [{k: v.detach().clone() for k, v in d.items()}
                           for d in self.ens.member_params()]
            self.gen_states = [g.get_state() for g in self.ens.generators]
        elif n == self.k + 1:
            self.grad = norms(self.ens.member_params([q.grad for q in self.ens.params]))
            self.moved = {f"m{i}.{k}": (v.detach() != self.params[i][k]).any()
                          for i, d in enumerate(self.ens.member_params()) for k, v in d.items()}

    def read(self, hist: List[List[float]]) -> dict:
        ok = len(hist) > self.k
        return {"params": self.params, "gen_states": self.gen_states,
                "grad": read(self.grad), "moved": {k: bool(v) for k, v in self.moved.items()},
                "loss": list(hist[self.k]) if ok else [math.nan] * len(self.ens.c_list)}


class Fits:
    """The window's ``fit(epochs, log_fn)``: the ensemble's fit, then composed
    inference over the test documents. After the first, it copies the final
    parameters and keeps the routed logits of its inference."""

    def __init__(self, ens: Ensemble, y_child, y_parent, route: str):
        self.ens, self.y_child, self.y_parent, self.route = ens, y_child, y_parent, route
        g = ens.g
        self.rows = [np.flatnonzero(np.asarray(g.test_mask)[g.n_vocab:] & (y_parent == c))
                     for c in range(len(ens.c_list))]
        self.final: Optional[List[Dict[str, torch.Tensor]]] = None
        self.logits: Optional[torch.Tensor] = None

    def __call__(self, epochs: int, log_fn: Callable) -> List[List[float]]:
        ens = self.ens
        hist = ens.fit(epochs, log_fn)
        first = self.final is None
        if first:
            self.final = [{k: v.detach().clone() for k, v in d.items()}
                          for d in ens.member_params()]
        out = eval_per_label(ens.g, self.y_child, self.y_parent, ens, ens.mapping,
                             route=self.route)
        if first:
            self.logits = routed(out["logits"], self.rows, ens.c_list)
        return hist


def set_up(cell, g, seed: int, device: torch.device) -> dict:
    """The ensemble on the graph ``g`` and its first epochs."""
    cfg, traffic = cell.config, cell.traffic
    if traffic["route"] != "ground_truth":
        raise NotImplementedError("the loop routes by the true parent")
    y_parent, y_child = labels(cell, seed, g.n_docs)
    if not np.array_equal(y_child, np.asarray(g.y)[g.n_vocab:]):
        raise ValueError("the corpus's finest labels are not the graph's")
    c_list = counts.member_classes(y_child, y_parent)
    init = counts.initial_params(cfg["model"], g.n_nodes, c_list, seed, device)
    kw = dict(cfg["trainer"])
    lr = kw.pop("lr")
    t = time.perf_counter()
    ens = Ensemble(g, y_child, y_parent, member_factory(cfg["model"], init, seed, device),
                   lr=lr, seed=seed, trainer_kwargs=dict(kw, device=device))
    for i, gen in enumerate(ens.generators):
        gen.manual_seed(counts.member_dropout_seed(seed, i))
    program.sync(device)
    ensemble_build_s = time.perf_counter() - t
    # the operator's part: NormAdj.from_graph's stages (operator.normalize, .csr_plan, .upload)
    plan_build_s = sum(s.seconds for s in profiling.stages()
                       if s.start >= t and s.name.startswith("operator."))
    hist = ens.fit(1, Epochs())
    grad1 = norms(ens.member_params([q.grad for q in ens.params]))
    hist += ens.fit(int(traffic["first_steps"]) - 1, Epochs())
    with torch.no_grad():
        delta = {f"m{i}.{k}": float((v.double() - init[i][k].double()).norm())
                 for i, d in enumerate(ens.member_params()) for k, v in d.items()}
    del init
    program.sync(device)
    first = {"loss": hist, "grad1": read(grad1), "delta": delta}
    return dict(ens=ens, y_child=y_child, y_parent=y_parent, first=first,
                timers={"plan_build_s": plan_build_s, "ensemble_build_s": ensemble_build_s,
                        "member_classes": c_list})


def check_epoch(traffic: dict, seed: int) -> int:
    return 1 + seed % int(traffic["check_within"])


def run(cell, g, n_classes: int, seed: int, seconds: float, on_epoch: List[Callable],
        device: torch.device) -> dict:
    """Set-up, then the window; returns what the harness and the check read."""
    s = set_up(cell, g, seed, device)
    ens, traffic = s["ens"], cell.traffic
    step = WindowStep(ens, check_epoch(traffic, seed))
    fits = Fits(ens, s["y_child"], s["y_parent"], traffic["route"])
    t0, times, failed, hist = window(fits, int(traffic["epochs_per_fit"]), seconds,
                                     [step] + list(on_epoch), device)
    final = None
    if fits.final is not None:
        final = {"params": fits.final, "logits": fits.logits.double().cpu().numpy()}
    return dict(t0=t0, times=times, failed=failed, adj=ens.adj, timers=s["timers"],
                compared={"first": s["first"], "window": step.read(hist), "final": final})


def reference(cell, graph: dict, params, compared: dict, seed: int, device: torch.device,
              precision: str = "float64") -> dict:
    """The reference's side of what ``run`` compares, at ``precision``, on
    ``graph`` (the reference's, with ``norm_w`` / ``self_w``): the members'
    set-up epochs from the seed's initial parameters (``params``, one model's,
    is not used), the window's step from the program's copied state, and the
    routed logits from the program's final parameters."""
    del params
    cfg = cell.config
    y_parent, y_child = labels(cell, seed, int(graph["n_docs"]))
    ens = ref_perlabel.Ensemble(cfg["model"], graph, y_child, y_parent, device, precision)
    c_list = counts.member_classes(y_child, y_parent)
    init = counts.initial_params(cfg["model"], len(graph["self_w"]), c_list, seed, device)
    gens = [torch.Generator(device=device).manual_seed(counts.member_dropout_seed(seed, i))
            for i in range(len(c_list))]
    adam = dict(cfg["adam"], lr=cfg["trainer"]["lr"])
    first = ens.train_steps(adam, init, gens, int(cell.traffic["first_steps"]))
    del init
    w = compared["window"]
    step = None
    if w["params"] is not None:
        for gen, st in zip(gens, w["gen_states"]):
            gen.set_state(st)
        step = ens.one_step(w["params"], gens)
    final = compared["final"]
    logits = ens.routed_logits(final["params"]) if final is not None else None
    return {"first": first, "window": step, "final": logits}


def _gap(prog, ref) -> float:
    """The largest gap of the members' losses, each against the larger of its
    reference value and the median one (a member of one class has a loss of
    0 on both sides)."""
    return check._rel_gap(np.asarray(prog, np.float64).ravel(),
                          np.asarray(ref, np.float64).ravel())


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    """``prog``: the program's ``compared`` (or the control's reference, which
    has no ``moved``); ``ref``: :func:`reference`'s."""
    p, r = prog["first"], ref["first"]
    update = check._leaf_gaps(p["delta"], r["delta"], check._moving(r["grad1"]))
    out = {"loss_gap": _gap(p["loss"], r["loss"]), "loss1_gap": _gap(p["loss"][:1], r["loss"][:1]),
           "grad_gap": max(check._leaf_gaps(p["grad1"], r["grad1"], list(r["grad1"]))),
           "update_gap": max(update), "update_median_gap": float(np.median(update))}
    pw, rw = prog["window"], ref["window"]
    pf = prog["final"]
    pf = pf["logits"] if isinstance(pf, dict) else pf
    if rw is None or ref["final"] is None or pf is None:
        out.update(step_loss_gap=math.inf, step_member_loss_gap=math.inf,
                   routed_logit_gap=math.inf, step_grad_gap=math.inf, step_unmoved=math.inf)
        return out
    moved = pw.get("moved")
    out["step_member_loss_gap"] = _gap(pw["loss"], rw["loss"])
    out["routed_logit_gap"] = check._rel_gap(np.asarray(pf), np.asarray(ref["final"]))
    out["step_loss_gap"] = max(out["step_member_loss_gap"], out["routed_logit_gap"])
    out["step_grad_gap"] = max(check._leaf_gaps(pw["grad"], rw["grad"], list(rw["grad"])))
    out["step_unmoved"] = (float(sum(not moved.get(k, False) for k in check._moving(rw["grad"])))
                           if moved is not None else 0.0)
    return out
