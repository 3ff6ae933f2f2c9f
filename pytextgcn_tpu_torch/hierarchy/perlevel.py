"""Per-level hierarchical cascade.

Port of ``pytextgcn_tpu/hierarchy/perlevel.py`` (the reference's
perlevel_amazon.py / perlevel_dbpedia.py, SURVEY.md §3.5): level 1 trains
on the coarsest labels; each deeper level's graph carries the
*ground-truth one-hot* of the previous level as extra document features
during training, and the previous level's *predicted softmax* at test time.

Edges and features are separate (ops/features.py), so a level's graph is a
``dataclasses.replace`` of labels and feature columns on one graph, and the
levels share one operator (``Trainer.share_adjacency``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.graph import TextGraph
from ..train.trainer import Trainer


def one_hot_np(labels: np.ndarray, n_classes: Optional[int] = None) -> np.ndarray:
    labels = np.asarray(labels, np.int64)
    n = int(labels.max()) + 1 if n_classes is None else n_classes
    out = np.zeros((labels.shape[0], n), np.float32)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def _with_labels_and_feats(g: TextGraph, y_docs, hierarchy_feats) -> TextGraph:
    y_nodes = np.zeros(g.n_nodes, np.int32)
    y_nodes[g.n_vocab:] = np.asarray(y_docs, np.int32)
    return dataclasses.replace(
        g, y=y_nodes,
        hierarchy_feats=None if hierarchy_feats is None
        else np.asarray(hierarchy_feats, np.float32),
    )


def train_per_level(
    g: TextGraph,
    level_labels: Sequence[np.ndarray],
    model_factory: Callable[[int, int], torch.nn.Module],
    lr: float = 0.05,
    epochs: int = 500,
    seed: int = 42,
    verbose: int = 0,
    trainer_kwargs: Optional[dict] = None,
):
    """Run the cascade over ``level_labels`` (coarsest first; each entry is
    the per-document integer labels of that level).

    ``model_factory(in_dim, out_dim)`` -> model. Level k's trainer is seeded
    ``seed + k``. Returns a dict with the final test metrics, the per-level
    trainers and histories.

    Hand-offs as in the reference: level k >= 2 trains with the ground-truth
    one-hot of level k-1 (perlevel_dbpedia.py:140) and is finally evaluated
    with the softmax of level k-1 *computed on its own graph*, which is fed
    the ground truth of level k-2 (perlevel_dbpedia.py:173-175,224-227).
    """
    trainer_kwargs = dict(trainer_kwargs or {})
    # the reference's per-level drivers train with PLAIN Adam — only the
    # flat drivers pass amsgrad=True (perlevel_amazon.py:84)
    if trainer_kwargs.get("optimizer") is None:
        trainer_kwargs["optimizer"] = "adam"
    trainers: List[Trainer] = []
    histories = []
    hierarchy_gt = None  # ground-truth one-hot of the previous level

    for lvl, y in enumerate(level_labels):
        y = np.asarray(y)
        n_classes = int(y.max()) + 1
        g_lvl = _with_labels_and_feats(g, y, hierarchy_gt)
        model = model_factory(g_lvl.in_dim, n_classes)
        trainer = Trainer(model, lr=lr, seed=seed + lvl, **trainer_kwargs)
        if trainers:
            # levels swap labels and features only; the operator is shared
            trainer.share_adjacency(trainers[0])
        histories.append(trainer.fit(g_lvl, epochs=epochs, n_classes=n_classes,
                                     verbose=verbose))
        trainers.append(trainer)
        hierarchy_gt = one_hot_np(y, n_classes)

    # final evaluation: the last level fed the previous level's predictions
    y_last = np.asarray(level_labels[-1])
    n_last = int(y_last.max()) + 1
    if len(level_labels) >= 2:
        prev_gt = one_hot_np(level_labels[-3]) if len(level_labels) >= 3 else None
        g_prev = _with_labels_and_feats(g, level_labels[-2], prev_gt)
        logits = trainers[-2].predict_logits(g_prev)[g.n_vocab:]
        g_eval = _with_labels_and_feats(g, y_last, torch.softmax(logits, -1).cpu().numpy())
    else:
        g_eval = _with_labels_and_feats(g, y_last, None)
    metrics = trainers[-1].evaluate(g_eval, n_classes=n_last)
    return {"metrics": metrics, "trainers": trainers, "histories": histories}
