"""Grid-search hyperparameter optimization with k-fold cross-validation.

Port of ``experiments/hyperopt.py`` (the reference's old/h_o_train.py and
its hierarchical and per-label variants): a grid over lr x dropout x max_df
x {GCN, EGCN}, k-fold over the document nodes with the graph's train and
validation masks rewritten per fold, one graph build per max_df, plain Adam
as the reference's hyperopt drivers train. The results CSV has the
reference's columns: LR, DO, max_df, model, mean f1, std f1 (and ``2lc``,
the parent classifier, per label).

A configuration that diverges (a non-finite loss, or a
``FloatingPointError``) is recorded as NaN, as the reference records its
failures; any other exception (a CUDA or build error, a bad argument)
stops the grid.

    python -m pytextgcn_tpu_torch.experiments.hyperopt --epochs 100
    python -m pytextgcn_tpu_torch.experiments.hyperopt --device cpu \\
        --hierarchy per-label --epochs 5 --k-split 2 --out "$(mktemp -d)/ho.csv"
"""

from __future__ import annotations

import argparse
import csv
import dataclasses
import itertools
import time

import numpy as np
import torch

from ..build.text2graph import Text2Graph
from ..config import ExperimentConfig
from ..models import EGCN, GCN
from ..train.trainer import Trainer
from ..utils import resolve_device
from .common import exact_f32, load_corpus
from .protocol import hybrid_k_flag


def kfold_indices(n: int, k: int, rng: np.random.Generator):
    """sklearn ``KFold(shuffle=True)`` semantics: shuffled indices split into
    k contiguous chunks (the first ``n % k`` one longer); each chunk is one
    fold's test set."""
    perm = rng.permutation(n)
    sizes = np.full(k, n // k)
    sizes[: n % k] += 1
    out, start = [], 0
    for s in sizes:
        test = perm[start: start + s]
        train = np.concatenate([perm[:start], perm[start + s:]])
        out.append((train, test))
        start += s
    return out


def _cv_f1(g, y_nodes, doc_nodes, folds, model_name, n_classes, n_hidden, dropout, lr,
           epochs, seed, device, hybrid_k=None, plan_cache=None):
    """Mean and std validation macro-F1 of one grid configuration over the
    folds (masks rewritten per fold as old/h_o_train.py:81-87 does). Raises
    ``FloatingPointError`` when a fold's loss is not finite."""
    scores = []
    for tr, te in folds:
        train_mask = np.zeros(g.n_nodes, bool)
        train_mask[doc_nodes[tr]] = True
        val_mask = np.zeros(g.n_nodes, bool)
        val_mask[doc_nodes[te]] = True
        g_fold = dataclasses.replace(g, y=y_nodes, train_mask=train_mask, val_mask=val_mask,
                                     test_mask=np.zeros(g.n_nodes, bool))
        cls = GCN if model_name == "GCN" else EGCN
        model = cls(g.in_dim, n_classes, n_hidden_gcn=n_hidden, dropout=dropout,
                    generator=torch.Generator().manual_seed(seed))
        # the reference's hyperopt drivers train with plain Adam, not the
        # flat drivers' amsgrad variant (old/h_o_train.py:98)
        trainer = Trainer(model, lr=lr, seed=seed, optimizer="adam", device=device,
                          hybrid_k=hybrid_k, plan_cache=plan_cache)
        hist = trainer.fit(g_fold, epochs=epochs, n_classes=n_classes, verbose=0)
        losses = [rec["loss"] for rec in hist]
        if not np.isfinite(losses).all():
            raise FloatingPointError(f"the loss diverged: {losses[-1]}")
        m = trainer.evaluate(g_fold, mask=val_mask, n_classes=n_classes)
        scores.append(m["f1_macro"])
    return float(np.mean(scores)), float(np.std(scores))


def _diverged(run):
    """``run()``'s (mean, std) F1, or NaNs when the configuration diverged."""
    try:
        return run()
    except FloatingPointError as e:
        print(f"config diverged ({e}); recording NaN", flush=True)
        return float("nan"), float("nan")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--dataset", default="synthetic")
    p.add_argument("--labels", default="Cat2")
    p.add_argument("--parent-labels", default="Cat1",
                   help="parent-level label column for the hierarchical modes")
    p.add_argument("--hierarchy", default="flat", choices=["flat", "per-level", "per-label"],
                   help="flat = old/h_o_train.py; per-level = old/h_o_hierarchical.py (the "
                        "true parent's one-hot appended to the document features); per-label "
                        "= old/h_o_lables.py (one grid per parent-class classifier, '2lc' "
                        "column in the CSV)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--n-docs", type=int, default=0,
                   help="synthetic-amazon / synthetic-dbpedia corpus size (0 = the default)")
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--k-split", type=int, default=3)
    p.add_argument("--n-hidden", type=int, default=100)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--lrs", type=float, nargs="+", default=[0.001, 0.005, 0.01, 0.05])
    p.add_argument("--dropouts", type=float, nargs="+", default=[0.5, 0.7])
    p.add_argument("--max-dfs", type=float, nargs="+", default=[0.5, 0.6, 0.7])
    p.add_argument("--models", nargs="+", default=["GCN", "EGCN"])
    p.add_argument("--hybrid-k", default="off",
                   help="'off' | 'auto' | int: the SpMM decomposition of the fold trainers "
                        "(plans cached per max_df graph under --plan-cache)")
    p.add_argument("--plan-cache", default=".plan_cache",
                   help="plan cache directory when --hybrid-k is on ('' = none)")
    p.add_argument("--device", default=None, help="default: the GPU (raises without one)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    hybrid_k = hybrid_k_flag(args.hybrid_k)
    plan_cache = (args.plan_cache or None) if hybrid_k is not None else None
    device = resolve_device(args.device)
    exact_f32()

    cfg = ExperimentConfig(dataset=args.dataset, labels=args.labels, data_dir=args.data_dir)
    cfg.train.seed = args.seed
    if args.n_docs:
        cfg.n_docs = args.n_docs
    if args.hierarchy == "flat":
        docs, labels, test_idx, _ = load_corpus(cfg)
        y_parent, y = None, labels[0]
    else:
        docs, labels, test_idx, _ = load_corpus(cfg, levels=[args.parent_labels, args.labels])
        y_parent, y = labels[0], labels[-1]
    n_classes = int(np.max(y)) + 1
    rng = np.random.default_rng(args.seed)

    prefix = {"flat": "HypOpt", "per-level": "Hierarchical_HypOpt",
              "per-label": "HypOpt_Labels"}[args.hierarchy]
    out_name = args.out or f"{prefix}_{args.labels}_{time.strftime('%d_%b_%y_%H_%M_%S')}.csv"
    rows = []

    def emit(row):
        rows.append(row)
        print(row, flush=True)
        with open(out_name, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(rows[0]))
            w.writeheader()
            w.writerows(rows)

    common = dict(n_hidden=args.n_hidden, epochs=args.epochs, seed=args.seed, device=device,
                  hybrid_k=hybrid_k, plan_cache=plan_cache)
    for mdf in args.max_dfs:
        t2g = Text2Graph(min_df=5 if args.dataset != "synthetic" else 1, max_df=mdf,
                         device=device)
        # per-level: the true parent's one-hot appended to the node features
        # (h_o_hierarchical.py:66,71, OneHotEncoder of y_top)
        hier = (np.eye(int(np.max(y_parent)) + 1, dtype=np.float32)[y_parent]
                if args.hierarchy == "per-level" else None)
        g = t2g.fit_transform(docs, y,
                              test_idx=np.arange(0) if args.hierarchy == "per-label" else test_idx,
                              hierarchy_feats=hier)
        print(f"Graph built (max_df={mdf}, {g.n_vocab} vocab)!", flush=True)

        if args.hierarchy == "per-label":
            # one grid per parent-class classifier over that parent's docs,
            # child labels relabeled contiguously (h_o_lables.py:75-94)
            for c in range(int(np.max(y_parent)) + 1):
                sel = np.asarray(y_parent) == c
                doc_nodes = np.flatnonzero(sel) + g.n_vocab
                classes = np.unique(np.asarray(y)[sel])
                y_nodes = np.zeros(g.n_nodes, np.int32)
                y_nodes[doc_nodes] = np.searchsorted(classes, np.asarray(y)[sel]).astype(np.int32)
                folds = kfold_indices(len(doc_nodes), args.k_split, rng)
                for model_name, dropout, lr in itertools.product(args.models, args.dropouts,
                                                                 args.lrs):
                    mean_f1, std_f1 = _diverged(lambda: _cv_f1(
                        g, y_nodes, doc_nodes, folds, model_name, len(classes),
                        dropout=dropout, lr=lr, **common))
                    emit({"2lc": f"classifier_{c}", "LR": lr, "DO": dropout, "max_df": mdf,
                          "model": model_name, "mean f1": mean_f1, "std f1": std_f1})
            continue

        doc_nodes = np.flatnonzero(np.asarray(g.train_mask) | np.asarray(g.test_mask))
        folds = kfold_indices(len(doc_nodes), args.k_split, rng)
        for dropout, lr, model_name in itertools.product(args.dropouts, args.lrs, args.models):
            mean_f1, std_f1 = _diverged(lambda: _cv_f1(
                g, np.asarray(g.y), doc_nodes, folds, model_name, n_classes,
                dropout=dropout, lr=lr, **common))
            emit({"LR": lr, "DO": dropout, "max_df": mdf, "model": model_name,
                  "mean f1": mean_f1, "std f1": std_f1})
    print(f"results -> {out_name}", flush=True)
    return rows


if __name__ == "__main__":
    main()
