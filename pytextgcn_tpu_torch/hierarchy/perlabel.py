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

The JAX package's expert-parallel step (``mesh``) is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.graph import TextGraph
from ..models import export_params
from ..train.checkpoint import save_checkpoint
from ..train.metrics import accuracy, macro_f1
from ..train.trainer import Trainer


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
):
    """Train one child-label classifier per parent class, one after the
    other.

    Returns ``{"trainers": [...], "mapping": {parent: [global child ids]},
    "histories": [...]}``: the mapping holds, per parent class, the sorted
    global child labels in local-label order (the reference's LabelEncoder
    ``classes_``, class_mapping.json). With
    ``save_dir``, each member is checkpointed as ``lvl2-cat{c}`` (its
    parameters, meta ``{"parent", "classes"}``) beside
    ``class_mapping.json``.
    """
    if mesh is not None:
        raise NotImplementedError(
            "the expert-parallel per-label step (mesh) is not ported yet (see ROADMAP.md)")
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


def eval_per_label(
    g: TextGraph,
    y_child: np.ndarray,
    y_parent: np.ndarray,
    trainers: List[Trainer],
    mapping: Dict[int, List[int]],
    parent_pred: Optional[np.ndarray] = None,
    route: str = "ground_truth",
):
    """Composed hierarchical inference (eval_perlabel.py:57-85), one member
    at a time (the JAX package's fallback to its batched pass, which gives
    the same predictions).

    ``route='ground_truth'`` routes each test document by its true parent
    class, as the reference does; ``route='predicted'`` by ``parent_pred``
    (per-document parent predictions, e.g. of a level-1 flat model). A
    document no member takes stays -1 and scores as a label of its own.
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
    for c, trainer in enumerate(trainers):
        sel = (router == c) & test_docs
        if not sel.any():
            continue
        logits = trainer.predict_logits(g_eval)[g.n_vocab:]
        local_pred = logits.argmax(dim=-1).cpu().numpy()[sel]
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
    }
