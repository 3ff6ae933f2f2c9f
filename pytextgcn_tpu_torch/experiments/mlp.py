"""TF-IDF + MLP baseline experiment (PyTorch port): flat, per-level and
per-label in one script.

Port of ``experiments/mlp.py`` (the reference's MLP_flat.py / MLP_level.py /
MLP_label.py): TF-IDF features fit on the train split, then
``baselines/mlp_pipeline.py`` at every label level; each level's test
accuracy / macro-F1 goes to the results CSV (``--result-file``) with
``model=MLP`` and the level as its category. The sparse first layer runs
in the CSR kernel (``--train-use-pallas``, the default). The MLP's own
defaults, lr 2e-3 and dropout 0.5 (MLP_flat.py:20-21), hold unless
``--train-lr`` / ``--model-dropout`` are passed.

Examples:
    python -m pytextgcn_tpu_torch.experiments.mlp --device cpu --hierarchy flat
    python -m pytextgcn_tpu_torch.experiments.mlp --hierarchy per-level \\
        --dataset synthetic-amazon
    python -m pytextgcn_tpu_torch.experiments.mlp --hierarchy per-label \\
        --dataset csv --data-dir DIR --levels coarse fine
"""

from __future__ import annotations

import sys

import numpy as np

from ..baselines import fit_tfidf_splits, mlp_flat, mlp_per_label, mlp_per_level
from ..config import check_ported, parse_config
from ..train.results import append_result
from . import common

HIERARCHIES = ("flat", "per-level", "per-label")


def default_levels(dataset: str):
    """The label levels per dataset, as the JAX package's experiments/mlp.py sets them."""
    return {"synthetic": ["lvl1", "lvl2"], "synthetic-amazon": ["lvl1", "lvl2"],
            "amazon": ["Cat1", "Cat2"]}.get(dataset, ["l1", "l2", "l3"])


def tfidf_splits(docs, level_labels, test_idx, val_idx):
    """The train / val / test split of ``docs`` and each level of
    ``level_labels`` (train: every document in neither index), through the
    train-only TF-IDF fit."""
    mask = np.zeros(len(docs), np.int8)  # 0 train, 1 val, 2 test
    mask[val_idx] = 1
    mask[test_idx] = 2
    tr, va, te = (np.flatnonzero(mask == k) for k in (0, 1, 2))
    level_labels = [np.asarray(y) for y in level_labels]
    return fit_tfidf_splits(
        [docs[i] for i in tr], [docs[i] for i in va], [docs[i] for i in te],
        [y[tr] for y in level_labels], [y[va] for y in level_labels],
        [y[te] for y in level_labels],
    )


def build_splits(cfg, levels):
    """The corpus at ``levels``, split as ``load_corpus`` splits it, through
    the train-only TF-IDF fit. Returns ``(splits, n_levels)``."""
    docs, level_labels, test_idx, val_idx = common.load_corpus(cfg, levels=levels)
    splits = tfidf_splits(docs, level_labels, test_idx, val_idx)
    print(f"Data loaded! {splits.x_train.shape} train features")
    return splits, len(level_labels)


def train_kwargs(cfg, passed) -> dict:
    """``train_mlp``'s settings from the config; ``passed``: the flags given
    on the command line (the MLP defaults hold for the others)."""
    return dict(
        hidden=tuple(cfg.model.mlp_hidden),
        lr=cfg.train.lr if "--train-lr" in passed else 2e-3,
        dropout=cfg.model.dropout if "--model-dropout" in passed else 0.5,
        epochs=cfg.train.epochs,
        seed=cfg.train.seed,
        verbose=cfg.train.verbose,
        use_pallas=cfg.train.use_pallas,
        device=cfg.device,
    )


def run(cfg, splits, n_levels: int, hierarchy: str, kwargs: dict):
    """The baseline on built splits, and a results row per level. Returns
    one result dict per level."""
    if hierarchy == "flat":
        results = [mlp_flat(splits, level, **kwargs) for level in range(n_levels)]
    elif hierarchy == "per-level":
        results = mlp_per_level(splits, **kwargs)
    elif hierarchy == "per-label":
        results = mlp_per_label(splits, **kwargs)
    else:
        raise ValueError(f"--hierarchy must be one of {HIERARCHIES}, got {hierarchy!r}")
    for cat, res in enumerate(results):
        print(f"[{hierarchy} category {cat}] accuracy {res['accuracy']: .4f} "
              f"f1-macro {res['f1_macro']: .4f}")
        if cfg.result_file:
            append_result(cfg.result_file, seed=cfg.train.seed, model="MLP",
                          hierarchy=hierarchy, f1_macro=res["f1_macro"],
                          accuracy=res["accuracy"], dataset=cfg.dataset, category=str(cat))
    return results


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    argv, hierarchy = common.pop_list_flag(argv, "--hierarchy")
    argv, levels = common.pop_list_flag(argv, "--levels")
    hierarchy = hierarchy[0] if hierarchy else "flat"
    if hierarchy not in HIERARCHIES:
        raise SystemExit(f"--hierarchy must be one of {', '.join(HIERARCHIES)}")
    cfg = parse_config(argv)
    check_ported(cfg, graph=False, minibatch=False, sharding=False)
    common.exact_f32()
    splits, n_levels = build_splits(cfg, levels or default_levels(cfg.dataset))
    return run(cfg, splits, n_levels, hierarchy, train_kwargs(cfg, set(argv)))


if __name__ == "__main__":
    main()
