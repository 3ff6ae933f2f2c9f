"""CUDA graphs of one epoch of ``Trainer.fit``.

On one card ``fit`` enqueues an epoch as two graph replays instead of
dispatching every op from Python:

* graph T: the train step's forward, masked cross-entropy and backward. The
  loss and the gradients stay in T's static buffers, where every replay
  writes them again;
* graph E: the evaluation's forward, loss, argmax, macro-F1 and accuracy,
  written with T's loss into one static ``[4]`` buffer (``result``), which
  ``fit`` reads in one copy.

The optimizer runs eagerly between them, on the gradients T left, so its
kernels, state and numbers are those of an eager step. Dropout draws from the
trainer's generator, registered with T: a replay draws the masks an eager
step would draw from the same generator state, and advances it as far.
Labels, masks and features are the graphs' inputs: :meth:`EpochGraphs.load`
copies a ``fit`` call's into their buffers. The CSR kernel's launches a
capture records are taken off the kernel's counters (none of them ran) and
added back at every replay, so ``ops/spmm_cuda.py::SpmmCsrKernel.launches``
and ``shapes`` keep counting the launches that ran; so do the embedding's
(``ops/embedding.py::SeluDropout.launches``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..ops import spmm_cuda
from ..ops.embedding import SeluDropout
from .profiling import span, stage


@dataclasses.dataclass
class Launches:
    """The CSR kernel's launches one graph holds, in all and by
    ``(n_rows, n_cols, H)``, and the embedding's (``embedding``)."""

    n: int = 0
    shapes: Dict[Tuple[int, int, int], int] = dataclasses.field(default_factory=dict)
    embedding: int = 0

    def count(self) -> None:
        """Add one replay's launches to the kernels' counters."""
        k = spmm_cuda.spmm_csr_kernel
        k.launches += self.n
        for shape, n in self.shapes.items():
            k.shapes[shape] = k.shapes.get(shape, 0) + n
        SeluDropout.launches += self.embedding


def capture(fn: Callable[[], torch.Tensor], generator: Optional[torch.Generator] = None):
    """``fn()`` captured as a CUDA graph (its random numbers drawn from
    ``generator``); returns the graph, ``fn``'s output (a static buffer) and
    the launches the capture recorded, which are taken off the kernels'
    counters again."""
    k = spmm_cuda.spmm_csr_kernel
    n0, shapes0, e0 = k.launches, dict(k.shapes), SeluDropout.launches
    graph = torch.cuda.CUDAGraph()
    if generator is not None:
        graph.register_generator_state(generator)
    try:
        with torch.cuda.graph(graph):
            out = fn()
    finally:
        rec = Launches(k.launches - n0, {s: n - shapes0.get(s, 0) for s, n in k.shapes.items()
                                         if n != shapes0.get(s, 0)},
                       SeluDropout.launches - e0)
        k.launches = n0
        k.shapes.clear()
        k.shapes.update(shapes0)
        SeluDropout.launches = e0
    return graph, out, rec


def hooked(params: Sequence[torch.Tensor]) -> bool:
    """Whether a gradient hook is registered on one of ``params``: a replay
    would not call it (autograd runs only while a graph is captured)."""
    return any(p._post_accumulate_grad_hooks or p._backward_hooks for p in params)


class EpochGraphs:
    """Graphs T and E of one trainer over one operator, one set of
    parameters and one set of input shapes (``key``), with their static
    inputs and outputs. Each is captured from the trainer's state as it
    stands, once the trainer has run its work eagerly on the same key (the
    warm-up: kernel loads, cuBLAS handles, the optimizer's lazy state): T
    here, E by :meth:`capture_eval`.

    ``step_fn(adj, feats, y, mask, adj_out)`` is the step's forward, loss and
    backward, returning the loss."""

    def __init__(self, key, params: List[torch.nn.Parameter], generator: torch.Generator,
                 adj, feats, adj_out, inputs: Sequence[Optional[torch.Tensor]],
                 step_fn: Callable):
        self.key = key
        # held: the graphs read the operator's plans and the parameters
        self.adj, self.adj_out, self.params = adj, adj_out, params
        self.inputs = [None if t is None else t.clone() for t in inputs]
        _, _, _, y_step, mask_step, x, hierarchy = self.inputs
        self.feats = dataclasses.replace(feats, x=x, hierarchy=hierarchy)
        for p in params:  # T's backward then writes the gradients anew
            p.grad = None
        with stage("trainer.capture"):
            self.step_graph, self.loss, self.step_launches = capture(
                lambda: step_fn(adj, self.feats, y_step, mask_step, adj_out).detach(),
                generator)
        self.grads = [p.grad for p in params]
        self.eval_graph: Optional[torch.cuda.CUDAGraph] = None

    def capture_eval(self, eval_fn: Callable) -> None:
        """Capture E: ``eval_fn(adj, feats, y, train_mask, val_mask, loss)``,
        the evaluation beside T's loss, returning the ``[4]`` result."""
        y, train_mask, val_mask = self.inputs[:3]
        with stage("trainer.capture"):
            self.eval_graph, self.result, self.eval_launches = capture(
                lambda: eval_fn(self.adj, self.feats, y, train_mask, val_mask, self.loss))

    def load(self, inputs: Sequence[Optional[torch.Tensor]]) -> None:
        """Copy a ``fit`` call's labels, masks and features into the graphs'
        buffers (``key`` holds their shapes)."""
        for buf, t in zip(self.inputs, inputs):
            if buf is not None:
                buf.copy_(t)

    def step(self, optimizer: torch.optim.Optimizer) -> torch.Tensor:
        """Replay T, then the optimizer's step; returns T's loss buffer."""
        for p, g in zip(self.params, self.grads):
            if p.grad is not g:  # an eager step between replays set its own
                p.grad = g
        with span("fit.replay", graph="T"):
            self.step_graph.replay()
        self.step_launches.count()
        optimizer.step()
        return self.loss

    def evaluate(self) -> torch.Tensor:
        """Replay E; returns the ``[4]`` result buffer."""
        with span("fit.replay", graph="E"):
            self.eval_graph.replay()
        self.eval_launches.count()
        return self.result
