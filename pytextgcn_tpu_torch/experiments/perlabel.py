"""Per-label ensemble experiment (PyTorch port).

Port of ``experiments/perlabel.py`` (the reference's perlabel_amazon.py +
eval_perlabel.py): one child classifier per parent class, then composed
hierarchical inference, in one driver. ``--save-model DIR`` writes the
members as ``DIR/lvl2-cat{c}`` beside ``DIR/class_mapping.json``;
``--eval-only`` loads them from there and only runs the inference.
``--route predicted`` routes test documents by a level-1 flat model's
predictions instead of their true parent (the reference's quirk, the
default ``ground_truth``). ``--train-ep true`` trains the members in one
batched step (one CSR kernel launch of width members x hidden per
application); with ``--train-n-devices N > 1`` (0: every visible card)
the members are spread over N ranks, one process each (NCCL a card; gloo
on the CPU), each rank stepping its block of them, and rank 0 writes the
results row (as the JAX driver's ensemble mesh, experiments/perlabel.py).

Examples:
    python -m pytextgcn_tpu_torch.experiments.perlabel --device cpu   # synthetic
    python -m pytextgcn_tpu_torch.experiments.perlabel --dataset synthetic-amazon \\
        --levels Cat1 Cat2 --graph-max-df 0.6 --save-model models/amazon
    python -m pytextgcn_tpu_torch.experiments.perlabel --dataset synthetic-amazon \\
        --levels Cat1 Cat2 --graph-max-df 0.6 --save-model models/amazon --eval-only
    python -m pytextgcn_tpu_torch.experiments.perlabel --dataset synthetic-amazon \
        --levels Cat1 Cat2 --graph-max-df 0.6 --train-ep true
    python -m pytextgcn_tpu_torch.experiments.perlabel --device cpu --train-ep true \
        --train-n-devices 2
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..config import check_ported, make_model, parse_config
from ..hierarchy import eval_per_label, train_per_label
from ..train.checkpoint import load_meta
from ..train.results import append_result
from ..train.trainer import Trainer
from . import common
from .perlevel import build_graph


def load_members(cfg, g):
    """The ensemble written by a run with ``--save-model DIR``: one
    trainer per ``DIR/lvl2-cat{c}`` and the mapping of
    ``DIR/class_mapping.json``."""
    with open(os.path.join(cfg.save_model, "class_mapping.json")) as f:
        mapping = {int(k): v for k, v in json.load(f).items()}
    trainers = []
    for c in sorted(mapping):
        path = os.path.join(cfg.save_model, f"lvl2-cat{c}")
        model = make_model(cfg.model, g.in_dim, len(load_meta(path)["classes"]))
        trainer = Trainer(model, lr=cfg.train.lr, seed=cfg.train.seed,
                          **common.trainer_kwargs(cfg, "adam"))
        trainer.restore(path)
        if trainers:
            trainer.share_adjacency(trainers[0])
        else:
            trainer.prepare(g)  # the operator the other members adopt
        trainers.append(trainer)
    return {"trainers": trainers, "mapping": mapping}


def run(cfg, g, y_parent, y_child, route: str = "ground_truth", eval_only: bool = False):
    """Train (or, with ``eval_only``, load) the ensemble on a built graph,
    evaluate it and append the results row. Returns the test metrics and
    predictions, with the members under "trainers" and, when trained here,
    their histories under "histories"."""
    if eval_only:
        if not cfg.save_model:
            raise SystemExit("--eval-only needs --save-model DIR to load the ensemble from")
        out = load_members(cfg, g)
    else:
        gen = torch.Generator().manual_seed(cfg.train.seed)
        kw = common.trainer_kwargs(cfg, "adam")
        mesh = None
        if common.over_ranks(cfg, ep=True):  # the ensemble over the group's ranks
            from ..parallel import make_mesh

            mesh = make_mesh(axis="ensemble", device=cfg.device)
            kw["device"] = None  # the mesh's
        out = train_per_label(
            g, y_child, y_parent,
            model_factory=lambda d_in, d_out: make_model(cfg.model, d_in, d_out,
                                                         generator=gen),
            lr=cfg.train.lr, epochs=cfg.train.epochs, seed=cfg.train.seed,
            verbose=cfg.train.verbose, save_dir=cfg.save_model, ep=cfg.train.ep,
            # the hierarchy protocols' default is plain Adam (perlabel_amazon.py:124)
            trainer_kwargs=kw, mesh=mesh,
        )

    parent_pred = None
    if route == "predicted":
        # a level-1 flat model routes the test documents
        y_nodes = np.zeros(g.n_nodes, np.int32)
        y_nodes[g.n_vocab:] = np.asarray(y_parent, np.int32)
        g1 = dataclasses.replace(g, y=y_nodes)
        n_parents = int(np.max(y_parent)) + 1
        lvl1 = Trainer(make_model(cfg.model, g1.in_dim, n_parents,
                                  generator=torch.Generator().manual_seed(cfg.train.seed)),
                       lr=cfg.train.lr, seed=cfg.train.seed, **common.trainer_kwargs(cfg))
        lvl1.share_adjacency(out["trainers"][0])
        lvl1.fit(g1, epochs=cfg.train.epochs, n_classes=n_parents, verbose=cfg.train.verbose)
        parent_pred = lvl1.predict_logits(g1)[g.n_vocab:].argmax(dim=-1).cpu().numpy()

    m = eval_per_label(g, y_child, y_parent, out["trainers"], out["mapping"],
                       parent_pred=parent_pred, route=route)
    print(f"test accuracy: {m['accuracy']: .4f}")
    print(f"test f1-macro: {m['f1_macro']: .4f}")
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if cfg.result_file and rank == 0:
        append_result(cfg.result_file, seed=cfg.train.seed, model=cfg.model.model.upper(),
                      hierarchy="per-label", f1_macro=m["f1_macro"], accuracy=m["accuracy"])
    return {**m, **out}


def parse(argv):
    """``(cfg, levels, route, eval_only)`` of a command line."""
    argv = list(argv)
    eval_only = "--eval-only" in argv
    if eval_only:
        argv.remove("--eval-only")
    argv, route = common.pop_list_flag(argv, "--route")
    route = route[0] if route else "ground_truth"
    if route not in ("ground_truth", "predicted"):
        raise SystemExit(f"--route must be 'ground_truth' or 'predicted', got {route!r}")
    argv, levels = common.pop_list_flag(argv, "--levels")
    cfg = parse_config(argv)
    check_ported(cfg, minibatch=False, sharding=False)
    return cfg, levels, route, eval_only


def _main(cfg, levels, route: str, eval_only: bool):
    with common.rank0_output(cfg, ep=not eval_only):
        common.exact_f32()
        g, (y_parent, y_child) = build_graph(cfg, levels or common.default_levels(cfg))
        return run(cfg, g, y_parent, y_child, route=route, eval_only=eval_only)


def _rank_main(rank: int, argv, address: str, n: int) -> None:
    """One of the ranks :func:`main` starts (``torch.multiprocessing``)."""
    cfg, levels, route, eval_only = parse(argv)
    common.join_rank(cfg, address, n, rank)
    _main(cfg, levels, route, eval_only)
    common.leave_group()


def main(argv=None):
    """Returns the test metrics and predictions with the members (None in
    a process that started ranks)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    cfg, levels, route, eval_only = parse(argv)
    if not eval_only and common.spawn_ranks(cfg, _rank_main, argv, ep=True):
        return None
    return _main(cfg, levels, route, eval_only)


if __name__ == "__main__":
    main()
