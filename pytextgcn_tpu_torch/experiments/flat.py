"""Flat TextGCN experiment (PyTorch port).

Port of ``experiments/flat.py``: one transductive graph over
train+val+test, a 2-layer GCN (or ``--model-model egcn|jk``), masked CE,
Adam(amsgrad), per-epoch val metrics, final test accuracy / macro-F1
appended to the results CSV; ``--save-model PATH`` checkpoints the trained
model (``Trainer.save``: ``PATH.npz`` / ``PATH.json``).

Examples:
    python -m pytextgcn_tpu_torch.experiments.flat                 # synthetic
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \\
        --model-n-hidden 100 --model-dropout 0.7 --train-lr 0.05 --train-seed 44
    python -m pytextgcn_tpu_torch.experiments.flat --device cpu --train-epochs 40
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \\
        --train-hybrid-k 4096                     # the hybrid SpMM
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \
        --train-hybrid-k auto --train-masked-head true --train-plan-cache plans
    python -m pytextgcn_tpu_torch.experiments.flat --device cpu --model-model jk
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \
        --train-batch-size 1024 --train-epochs 3 # mini-batches on subgraphs
    python -m pytextgcn_tpu_torch.experiments.flat --graph-backend device  # count on the card
    python -m pytextgcn_tpu_torch.experiments.flat --device cpu --train-sharding halo \
        --train-n-devices 2                       # 2 ranks over gloo on the CPU
    torchrun --nproc-per-node 4 -m pytextgcn_tpu_torch.experiments.flat \
        --train-sharding allgather                # one rank a card, NCCL
    python -m pytextgcn_tpu_torch.experiments.flat --dataset synthetic-amazon \
        --train-sharding hybrid --train-hybrid-k 4096 --train-hybrid-fused on \
        --train-masked-head true --train-n-devices 4   # sharded hybrid, masked head

``--train-sharding allgather|halo|hybrid`` partitions the graph over ranks
(parallel/), with ``--train-masked-head`` under any of them: under
torchrun every rank joins its group; otherwise
``--train-n-devices N > 1`` starts N local ranks, one a card, and 1 runs
this process as a group of one. Every rank builds the same graph; rank 0
alone prints, writes the results row and saves.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..build.text2graph import Text2Graph
from ..config import check_ported, make_model, parse_config
from ..train.metrics import confusion_matrix
from ..train.results import append_result
from ..train.trainer import Trainer
from . import common


def build_graph(cfg):
    """The run's graph: a saved artifact (``--load-graph``) or the corpus
    through ``Text2Graph``. Returns ``(graph, n_classes)``."""
    if cfg.load_graph is not None:
        g = Text2Graph.load_graph(cfg.load_graph)
        n_classes = int(np.max(np.asarray(g.y))) + 1
        print(f"Graph loaded from {cfg.load_graph}! n_classes={n_classes}")
        return g, n_classes
    docs, labels, test_idx, val_idx = common.load_corpus(cfg)
    y = labels[0]
    n_classes = int(np.max(y)) + 1
    print(f"Data loaded! {len(docs)} docs, {n_classes} classes")
    g = common.build_graph(cfg.graph, docs, y, test_idx, val_idx, cfg.train.verbose,
                           device=cfg.device)
    print("Graph built!")
    return g, n_classes


def run(cfg, g, n_classes):
    """Train (on the full graph, or on mini-batches of its neighborhood
    subgraphs with ``--train-batch-size > 0``), evaluate on the full graph
    and append the results row. Returns the test metrics plus the
    per-epoch history under ``"history"`` and the trainer under
    ``"trainer"``."""
    model = make_model(cfg.model, g.in_dim, n_classes,
                       generator=torch.Generator().manual_seed(cfg.train.seed))
    trainer = Trainer(model, lr=cfg.train.lr, seed=cfg.train.seed,
                      **common.trainer_kwargs(cfg))
    if cfg.train.batch_size > 0:
        history = trainer.fit_minibatch(
            g,
            epochs=cfg.train.epochs,
            batch_size=cfg.train.batch_size,
            n_classes=n_classes,
            verbose=cfg.train.verbose,
        )
    else:
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
    if cfg.save_model:
        trainer.save(cfg.save_model, epoch=len(history))  # rank 0 writes
    mesh = trainer.aggregation.mesh
    if cfg.result_file and (mesh is None or mesh.rank == 0):
        append_result(
            cfg.result_file,
            seed=cfg.train.seed,
            model=cfg.model.model.upper(),
            hierarchy="flat",
            f1_macro=metrics["f1_macro"],
            accuracy=metrics["accuracy"],
        )
    return {**metrics, "history": history, "trainer": trainer}


def _main(cfg):
    with common.rank0_output(cfg):
        common.exact_f32()
        g, n_classes = build_graph(cfg)
        return run(cfg, g, n_classes)


def _rank_main(rank: int, argv, address: str, n: int) -> None:
    """One of the ranks :func:`main` starts (``torch.multiprocessing``)."""
    cfg = parse_config(argv)
    common.join_rank(cfg, address, n, rank)
    _main(cfg)
    common.leave_group()


def main(argv=None):
    """Run the flat protocol. Returns the test metrics plus the per-epoch
    history under ``"history"`` (None in a process that started ranks)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = parse_config(argv)
    check_ported(cfg)
    if common.spawn_ranks(cfg, _rank_main, argv):
        return None
    return _main(cfg)


if __name__ == "__main__":
    main()
