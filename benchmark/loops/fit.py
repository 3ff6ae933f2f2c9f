"""Loop ``fit``: the protocol's full-graph training, ``Trainer.fit(g,
epochs=<epochs_per_fit>, eval_every=<eval_every>, verbose=1, log_fn=...)``
on one trainer (``experiments/flat.py::run``'s call).

Set-up: the trainer from the benchmark's parameters, its operator
(``Trainer.prepare``, timed as ``plan_build_s``), and the traffic's
``first_steps`` epochs through ``fit`` itself (one call of one epoch, then
one of the rest), which also build the kernels on a checkout's first run.

Window: ``fit`` again and again on the same trainer. ``log_fn`` stamps every
epoch's end (``fit`` logs an epoch once its evaluation's values are on the
host) and stops the window at the first epoch end past the deadline, once
the window's first ``fit`` has returned its history.

Compared with the reference (``benchmark/reference/train.py``):

* the set-up's epochs, from the seed: each epoch's train and validation
  loss, each leaf's first gradient norm (read where autograd accumulates it
  into ``.grad``, as the optimizer gets it) and its change over the epochs;
* one step of the window, from the program's own state: at an epoch ``k``
  of the window's first ``fit`` drawn from the seed (``1 <= k <=
  check_within``), the parameters and the dropout generator's state are
  copied; the reference takes them and gives epoch ``k``'s validation loss
  and step ``k + 1``'s loss and gradient norms, which the program's history
  and its ``.grad`` give on the other side. The optimizer's update is
  compared in the set-up's epochs only: following it in the window would need
  the optimizer's internal state.
"""

from __future__ import annotations

import gc
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from benchmark import check, program, weights
from benchmark.reference import train as ref_train


class StopWindow(Exception):
    """Raised from ``fit``'s ``log_fn`` at the first epoch end past the window."""


class GradNorms:
    """Each leaf's gradient norm, taken where autograd accumulates it into
    ``.grad`` in the next backward pass (a device tensor; no sync)."""

    def __init__(self, named: Dict[str, torch.nn.Parameter]):
        self.names = list(named)
        self.norms: Dict[str, torch.Tensor] = {}
        self.handles = [p.register_post_accumulate_grad_hook(self._hook(k))
                        for k, p in named.items()]

    def _hook(self, k: str) -> Callable:
        def hook(p):
            if k not in self.norms:
                self.norms[k] = p.grad.detach().double().norm()
        return hook

    def remove(self) -> None:
        for h in self.handles:
            h.remove()

    def read(self) -> Dict[str, float]:
        return {k: float(self.norms[k]) if k in self.norms else math.nan for k in self.names}


class Epochs:
    """``fit``'s ``log_fn``: stamps the end of every epoch, counts the epochs
    whose loss is not a number, calls ``on_epoch(k)`` with the epoch's
    number, and, once ``armed``, stops at the deadline."""

    def __init__(self, deadline: float = math.inf, on_epoch: List[Callable] = ()):
        self.times: List[float] = []
        self.failed = 0
        self.deadline = deadline
        self.on_epoch = list(on_epoch)
        self.armed = False

    def __call__(self, msg: str) -> None:
        if not msg.startswith("["):  # the closing "training took" line
            return
        t = time.perf_counter()
        self.times.append(t)
        if "nan" in msg:
            self.failed += 1
        for f in self.on_epoch:
            f(len(self.times))
        if self.armed and t >= self.deadline:
            raise StopWindow


class WindowStep:
    """At window epoch ``k``: copies the parameters and the dropout
    generator's state and hooks the next step's gradients; at ``k + 1``
    takes the hooks off and notes which leaves the step changed (device
    tensors, read once the window has closed)."""

    def __init__(self, trainer, k: int):
        self.trainer, self.k = trainer, k
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.gen_state = None
        self.grads: Optional[GradNorms] = None
        self.moved: Dict[str, torch.Tensor] = {}

    def __call__(self, n: int) -> None:
        named = dict(self.trainer.model.named_parameters())
        if n == self.k:
            self.params = {k: p.detach().clone() for k, p in named.items()}
            self.gen_state = self.trainer.generator.get_state()
            self.grads = GradNorms(named)
        elif n == self.k + 1:
            self.grads.remove()
            self.moved = {k: (p.detach() != self.params[k]).any() for k, p in named.items()}

    def read(self, hist: List[dict]) -> dict:
        """The program's side of the step: epoch ``k``'s validation loss and
        step ``k + 1``'s loss from the window's first history, the step's
        gradient norms, and whether it changed each leaf."""
        k, ok = self.k, len(hist) > self.k
        return {"params": self.params, "gen_state": self.gen_state,
                "grad": self.grads.read() if self.grads is not None else {},
                "moved": {name: bool(m) for name, m in self.moved.items()},
                "val_loss": hist[k - 1].get("val_loss", math.nan) if ok else math.nan,
                "loss": hist[k]["loss"] if ok else math.nan}


def check_epoch(traffic: dict, seed: int) -> int:
    return 1 + seed % int(traffic["check_within"])


def fitter(trainer, g, n_classes: int, traffic: dict) -> Callable:
    """``fit(epochs, log_fn)``: the protocol's call of ``Trainer.fit``."""
    return lambda n, log: trainer.fit(g, epochs=n, n_classes=n_classes,
                                      eval_every=int(traffic["eval_every"]), verbose=1,
                                      log_fn=log)


def set_up(cell, g, n_classes: int, seed: int, device: torch.device) -> dict:
    """Parameters, trainer, operator and the first epochs on the graph ``g``."""
    cfg, traffic = cell.config, cell.traffic
    params = weights.initial_params(cfg["model"], g.n_nodes, n_classes, seed, device)
    trainer = program.make_trainer(cfg, g, n_classes, params, seed, device)
    t = time.perf_counter()
    adj, _ = trainer.prepare(g)
    program.sync(device)
    plan_build_s = time.perf_counter() - t
    fit = fitter(trainer, g, n_classes, traffic)
    named = dict(trainer.model.named_parameters())
    grads = GradNorms(named)
    hist = fit(1, Epochs())
    grads.remove()
    hist += fit(int(traffic["first_steps"]) - 1, Epochs())
    with torch.no_grad():
        delta = {k: float((p.double() - params[k].double()).norm()) for k, p in named.items()}
    del params
    program.sync(device)
    first = {"loss": [h["loss"] for h in hist], "val_loss": [h["val_loss"] for h in hist],
             "grad1": grads.read(), "delta": delta}
    return dict(trainer=trainer, adj=adj, first=first, timers={"plan_build_s": plan_build_s})


def window(fit: Callable, epochs_per_fit: int, seconds: float, on_epoch: List[Callable],
           device: torch.device):
    """``fit`` over and over until ``seconds`` have passed, stopping at the
    first epoch end after that once the first call has returned. The set-up's
    objects are moved out of the garbage collector's reach first
    (``gc.freeze``), as a long-running trainer's start-up objects would be.
    Returns the window's start, every epoch's end (host clock), the epochs
    that failed and the first call's history."""
    gc.collect()
    gc.freeze()
    t0 = time.perf_counter()
    log = Epochs(t0 + seconds, on_epoch)
    first: Optional[List[dict]] = None
    try:
        while True:
            hist = fit(epochs_per_fit, log)
            if first is None:
                first, log.armed = hist, True
    except StopWindow:
        pass
    program.sync(device)
    return t0, log.times, log.failed, first or []


def run(cell, g, n_classes: int, seed: int, seconds: float, on_epoch: List[Callable],
        device: torch.device) -> dict:
    """Set-up, then the window; returns what the harness and the check read."""
    s = set_up(cell, g, n_classes, seed, device)
    traffic = cell.traffic
    step = WindowStep(s["trainer"], check_epoch(traffic, seed))
    t0, times, failed, hist = window(fitter(s["trainer"], g, n_classes, traffic),
                                     int(traffic["epochs_per_fit"]), seconds,
                                     [step] + list(on_epoch), device)
    return dict(t0=t0, times=times, failed=failed, trainer=s["trainer"], adj=s["adj"],
                timers=s["timers"], compared={"first": s["first"], "window": step.read(hist)})


def reference(cell, graph: dict, params: Dict[str, torch.Tensor], compared: dict, seed: int,
              device: torch.device, precision: str = "float64") -> dict:
    """The reference's side of what ``run`` compares, at ``precision``, on
    ``graph`` (the reference's, with ``norm_w`` / ``self_w``) from the
    initial parameters ``params`` and, for the window's step, the program's
    copied state in ``compared``."""
    cfg = cell.config
    dtype = torch.float64 if precision == "float64" else torch.float32
    a, a_t = ref_train.sparse_ahat(graph["src"], graph["dst"], graph["norm_w"],
                                   graph["self_w"], dtype, device)
    put = lambda x: torch.as_tensor(x, device=device)
    train_mask, val_mask = put(graph["train_mask"]), put(graph["val_mask"])
    m = ref_train.Model(weights.model_kind(cfg["model"]), cfg["model"], a, a_t,
                        put(graph["y"]), precision)
    gen = torch.Generator(device=device).manual_seed(ref_train.dropout_seed(seed))
    first = ref_train.train_steps(m, dict(cfg["adam"], lr=cfg["trainer"]["lr"]), params,
                                  train_mask, val_mask, gen, int(cell.traffic["first_steps"]))
    w = compared["window"]
    step = None
    if w["params"] is not None:
        gen.set_state(w["gen_state"])
        step = ref_train.one_step(m, w["params"], train_mask, val_mask, gen)
    return {"first": first, "window": step}


def compare(prog: dict, ref: dict) -> Dict[str, float]:
    return {**check.compare_training(prog["first"], ref["first"]),
            **check.compare_step(prog["window"], ref["window"])}
