"""The plain reference of the per-label ensemble: BeFranke/PyTextGCN
``perlabel_amazon.py`` (one child GCN per Cat1 parent) with
``eval_perlabel.py`` (composed inference), SURVEY.md §3.6.

Each member is trained on its own, one after the other, never stacked: its
parent's child labels relabelled contiguously (the sorted distinct child
labels of the parent's documents, as the reference's LabelEncoder fits
them), the model kind's forward pass at its own class count
(``benchmark/models/gcn.py``) on the sparse ``A_hat`` of
``benchmark/reference/train.py``, the masked mean cross-entropy over the
train documents of its parent, its own dropout generator, and plain Adam
(torch's defaults: betas 0.9 / 0.999, eps 1e-8, no AMSGrad,
``perlabel_amazon.py:124``) written out by ``reference/train.py``. So the
program's padding, block-diagonal product and member slicing are tested, not
repeated. Plain torch in float64 (``"float64"``), with TF32 off; it imports
nothing of the program.

Departures from ``perlabel_amazon.py``, each on purpose:

* the graph is built once over every document and shared by the members;
  the reference builds it once per class, from the same corpus and settings,
  which gives the same graph;
* the members' initial parameters and dropout streams come from the
  benchmark (``benchmark/models/perlabel.py``), or from the program's copied
  state for a step of the timed window; the reference draws its masks from
  torch's one global stream;
* the members train a few steps from given parameters, the comparison's,
  not 500 epochs (the reference's per-label driver has no early stop; the
  validation losses ``reference/train.py`` computes are not compared);
* composed inference routes each test document by its true parent class
  (``eval_perlabel.py:73``, whose level-1 predictions are never used) and
  gives that member's logits, not their argmax.

``precision``: ``"float64"`` is the reference; ``"tf32"`` the control
(float32, dense products' operands rounded to TF32), as in
``reference/train.py``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.models import gcn
from benchmark.reference import train as ref_train


def tf32_off() -> None:
    """Dense products and cuDNN in full float32 (and float64) precision."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def members(y_child, y_parent, n_vocab: int) -> List[dict]:
    """Per parent class, in order: ``classes`` (its documents' distinct child
    labels, sorted), ``y`` (node labels: each of its documents' child label's
    place in ``classes``, 0 elsewhere) and ``rows`` (node mask of its
    documents). ``y_child``, ``y_parent``: per document."""
    y_child, y_parent = np.asarray(y_child, np.int64), np.asarray(y_parent, np.int64)
    out = []
    for c in range(int(y_parent.max()) + 1):
        docs = y_parent == c
        classes = np.unique(y_child[docs])
        y = np.zeros(n_vocab + len(y_child), np.int64)
        y[n_vocab:][docs] = np.searchsorted(classes, y_child[docs])
        rows = np.zeros(n_vocab + len(y_child), bool)
        rows[n_vocab:] = docs
        out.append({"classes": classes, "y": y, "rows": rows})
    return out


class Ensemble:
    """The members as independent models on one ``A_hat``, at one precision."""

    def __init__(self, model: dict, graph: dict, y_child, y_parent, device: torch.device,
                 precision: str = "float64"):
        """``graph``: ``src``, ``dst``, ``norm_w``, ``self_w`` (``A_hat``'s
        off-diagonal and diagonal weights), ``n_vocab``, ``train_mask``,
        ``val_mask``, ``test_mask`` (node masks)."""
        if model["kind"] != "gcn":
            raise NotImplementedError("the reference's members are GCNs")
        tf32_off()
        dtype = torch.float64 if precision == "float64" else torch.float32
        self.a, self.a_t = ref_train.sparse_ahat(graph["src"], graph["dst"], graph["norm_w"],
                                                 graph["self_w"], dtype, device)
        self.n_vocab = int(graph["n_vocab"])
        self.members = members(y_child, y_parent, self.n_vocab)
        put = lambda x: torch.as_tensor(x, device=device)
        self.models = [ref_train.Model(gcn, model, self.a, self.a_t, put(m["y"]), precision)
                       for m in self.members]
        self.train = [put(np.asarray(graph["train_mask"]) & m["rows"]) for m in self.members]
        self.val = [put(np.asarray(graph["val_mask"]) & m["rows"]) for m in self.members]
        self.test = [np.asarray(graph["test_mask"]) & m["rows"] for m in self.members]
        self.model = model

    @staticmethod
    def _keyed(per_member: List[Dict[str, float]]) -> Dict[str, float]:
        return {f"m{i}.{k}": v for i, d in enumerate(per_member) for k, v in d.items()}

    def train_steps(self, adam: dict, params: List[Dict[str, torch.Tensor]],
                    gens: List[torch.Generator], steps: int) -> dict:
        """``steps`` train steps of every member from ``params`` with a fresh
        Adam each (``adam``: ``lr``, ``betas``, ``eps``, ``amsgrad``), member
        ``i``'s dropout drawn from ``gens[i]``. Returns ``loss``, per epoch
        the members' losses, and per member leaf (``m<i>.<leaf>``) ``grad1``,
        the first step's gradient norm, and ``delta``, the norm of its change
        over the steps."""
        runs = [ref_train.train_steps(m, adam, p, tr, va, gen, steps)
                for m, p, tr, va, gen in zip(self.models, params, self.train, self.val, gens)]
        return {"loss": [list(row) for row in zip(*(r["loss"] for r in runs))],
                "grad1": self._keyed([r["grad1"] for r in runs]),
                "delta": self._keyed([r["delta"] for r in runs])}

    def one_step(self, params: List[Dict[str, torch.Tensor]],
                 gens: List[torch.Generator]) -> dict:
        """One train step of every member from ``params``, member ``i``'s
        dropout from ``gens[i]`` as it stands: ``loss``, the members'
        losses, and ``grad``, each member leaf's gradient norm."""
        runs = [ref_train.one_step(m, p, tr, va, gen)
                for m, p, tr, va, gen in zip(self.models, params, self.train, self.val, gens)]
        return {"loss": [r["loss"] for r in runs],
                "grad": self._keyed([r["grad"] for r in runs])}

    def routed_logits(self, params: List[Dict[str, torch.Tensor]]) -> np.ndarray:
        """Composed inference routed by the true parent: each member's logits
        at the test documents of its parent, members in order, documents in
        node order, each row its member's class count long, concatenated
        (float64, on the host)."""
        out = []
        with torch.no_grad():
            for m, p, test in zip(self.models, params, self.test):
                logits = gcn.forward(self.model, m.params(p),
                                     lambda x: torch.sparse.mm(self.a, x), m.mm, lambda h: h)
                rows = torch.as_tensor(np.flatnonzero(test), device=logits.device)
                out.append(logits.index_select(0, rows).double().cpu().numpy().ravel())
        return np.concatenate(out) if out else np.zeros(0)

