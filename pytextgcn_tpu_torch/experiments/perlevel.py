"""Per-level hierarchical TextGCN experiment (PyTorch port).

Port of ``experiments/perlevel.py`` (the reference's perlevel_amazon.py /
perlevel_dbpedia.py): one graph over the corpus, then the cascade of
:func:`~pytextgcn_tpu_torch.hierarchy.train_per_level` over ``--levels``
(coarse to fine), the last level's test accuracy / macro-F1 appended to the
results CSV.

Examples:
    python -m pytextgcn_tpu_torch.experiments.perlevel --device cpu   # synthetic
    python -m pytextgcn_tpu_torch.experiments.perlevel --dataset synthetic-amazon \\
        --levels Cat1 Cat2 --graph-max-df 0.6
    python -m pytextgcn_tpu_torch.experiments.perlevel --dataset synthetic-dbpedia \\
        --levels l1 l2 l3 --graph-max-df 0.4 --graph-min-df 100 --graph-window-size 5
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import check_ported, make_model, parse_config
from ..hierarchy import train_per_level
from ..train.results import append_result
from . import common


def build_graph(cfg, levels):
    """The corpus at ``levels`` through ``Text2Graph`` (labelled with the
    finest level). Returns ``(graph, level_labels)``."""
    docs, level_labels, test_idx, val_idx = common.load_corpus(cfg, levels=levels)
    print(f"Data loaded! {len(docs)} docs, {len(level_labels)} levels")
    g = common.build_graph(cfg.graph, docs, level_labels[-1], test_idx, val_idx,
                           cfg.train.verbose, device=cfg.device)
    print("Graph built!")
    return g, level_labels


def run(cfg, g, level_labels):
    """The cascade on a built graph, and the results row. Returns the test
    metrics, with the per-level trainers and histories under "trainers" and
    "histories"."""
    gen = torch.Generator().manual_seed(cfg.train.seed)
    res = train_per_level(
        g, level_labels,
        model_factory=lambda d_in, d_out: make_model(cfg.model, d_in, d_out, generator=gen),
        lr=cfg.train.lr, epochs=cfg.train.epochs, seed=cfg.train.seed,
        verbose=cfg.train.verbose,
        # the hierarchy protocols' default is plain Adam (perlevel_amazon.py:84)
        trainer_kwargs=common.trainer_kwargs(cfg, "adam"),
    )
    m = res["metrics"]
    print(f"Test Accuracy: {m['accuracy']: .4f}")
    print(f"F1-Macro: {m['f1_macro']: .4f}")
    if cfg.result_file:
        append_result(cfg.result_file, seed=cfg.train.seed, model=cfg.model.model.upper(),
                      hierarchy="per-level", f1_macro=m["f1_macro"], accuracy=m["accuracy"])
    return {**m, "trainers": res["trainers"], "histories": res["histories"]}


def main(argv=None):
    argv, levels = common.pop_list_flag(sys.argv[1:] if argv is None else argv, "--levels")
    cfg = parse_config(argv)
    check_ported(cfg, minibatch=False, sharding=False)
    common.exact_f32()
    g, level_labels = build_graph(cfg, levels or common.default_levels(cfg))
    return run(cfg, g, level_labels)


if __name__ == "__main__":
    main()
