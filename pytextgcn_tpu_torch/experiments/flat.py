"""Flat TextGCN experiment (PyTorch port).

Port of ``experiments/flat.py``: one transductive graph over
train+val+test, a 2-layer GCN, masked CE, Adam(amsgrad), per-epoch val
metrics, final test accuracy / macro-F1 appended to the results CSV.

Examples:
    python -m pytextgcn_tpu_torch.experiments.flat                 # synthetic
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \\
        --model-n-hidden 100 --model-dropout 0.7 --train-lr 0.05 --train-seed 44
    python -m pytextgcn_tpu_torch.experiments.flat --device cpu --train-epochs 40
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \\
        --train-hybrid-k 4096                     # the hybrid SpMM
"""

from __future__ import annotations

import numpy as np
import torch

from ..build.text2graph import Text2Graph
from ..config import (check_ported, hybrid_f32_mode_arg, hybrid_fused_arg, hybrid_k_arg,
                      make_model, parse_config)
from ..train.metrics import confusion_matrix
from ..train.results import append_result
from ..train.trainer import Trainer
from .common import load_corpus


def build_graph(cfg):
    """The run's graph: a saved artifact (``--load-graph``) or the corpus
    through ``Text2Graph``. Returns ``(graph, n_classes)``."""
    if cfg.load_graph is not None:
        g = Text2Graph.load_graph(cfg.load_graph)
        n_classes = int(np.max(np.asarray(g.y))) + 1
        print(f"Graph loaded from {cfg.load_graph}! n_classes={n_classes}")
        return g, n_classes
    docs, labels, test_idx, val_idx = load_corpus(cfg)
    y = labels[0]
    n_classes = int(np.max(y)) + 1
    print(f"Data loaded! {len(docs)} docs, {n_classes} classes")
    t2g = Text2Graph(
        min_df=cfg.graph.min_df,
        max_df=cfg.graph.max_df,
        window_size=cfg.graph.window_size,
        max_length=cfg.graph.max_length,
        rm_stopwords=cfg.graph.rm_stopwords,
        backend=cfg.graph.backend,
        save_path=cfg.graph.save_path,
        verbose=cfg.train.verbose,
        n_jobs=8,
    )
    g = t2g.fit_transform(docs, y, test_idx=test_idx, val_idx=val_idx)
    print("Graph built!")
    return g, n_classes


def run(cfg, g, n_classes):
    """Train and evaluate on a built graph and append the results row.
    Returns the test metrics plus the per-epoch history under
    ``"history"``."""
    model = make_model(cfg.model, g.in_dim, n_classes,
                       generator=torch.Generator().manual_seed(cfg.train.seed))
    trainer = Trainer(
        model, lr=cfg.train.lr, seed=cfg.train.seed,
        optimizer=None if cfg.train.optimizer == "default" else cfg.train.optimizer,
        use_pallas=cfg.train.use_pallas,
        pallas_dtype=cfg.train.pallas_dtype,
        device=cfg.device,
        hybrid_k=hybrid_k_arg(cfg.train),
        hybrid_fused=hybrid_fused_arg(cfg.train),
        hybrid_f32_mode=hybrid_f32_mode_arg(cfg.train),
    )
    history = trainer.fit(
        g,
        epochs=cfg.train.epochs,
        n_classes=n_classes,
        verbose=cfg.train.verbose,
        eval_every=cfg.train.eval_every,
        early_stopping=cfg.train.early_stopping,
    )
    metrics = trainer.evaluate(g, n_classes=n_classes)
    print(f"Test Accuracy: {metrics['accuracy']: .4f}")
    print(f"F1-Macro: {metrics['f1_macro']: .4f}")
    if cfg.train.verbose > 0:
        pred = trainer.predict_logits().argmax(dim=-1)
        dev = pred.device
        cm = confusion_matrix(pred, torch.as_tensor(g.y, device=dev),
                              torch.as_tensor(g.test_mask, device=dev), n_classes)
        print("Confusion matrix:")
        print(cm.cpu().numpy())
    if cfg.result_file:
        append_result(
            cfg.result_file,
            seed=cfg.train.seed,
            model=cfg.model.model.upper(),
            hierarchy="flat",
            f1_macro=metrics["f1_macro"],
            accuracy=metrics["accuracy"],
        )
    return {**metrics, "history": history}


def main(argv=None):
    """Run the flat protocol. Returns the test metrics plus the per-epoch
    history under ``"history"``."""
    cfg = parse_config(argv)
    check_ported(cfg)
    g, n_classes = build_graph(cfg)
    return run(cfg, g, n_classes)


if __name__ == "__main__":
    main()
