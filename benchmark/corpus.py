"""The benchmark's corpus generator and split: frozen copies.

``protocol_corpus`` is ``pytextgcn_tpu_torch/data/synthetic.py::protocol_corpus``
and ``split_blocks`` is ``pytextgcn_tpu_torch/experiments/common.py::split_blocks``,
both as of commit 313c710, copied so that a change to the program cannot
move the benchmark's inputs. The generator's knobs are not copied: they come
from the configuration file's ``data.corpus`` (for ``synthetic-amazon`` the
port's ``PROTOCOL_CFGS["amazon"]``, value for value), so a configuration of
another corpus shape is a new data file, not new code.

The stand-in corpus: the reference's Amazon CSVs are not public in a form
that ships with the repository, so documents are drawn from class-conditional
Zipfian word distributions calibrated to the reference's flat Amazon accuracy
(the port's docstrings give the calibration).
"""

from __future__ import annotations

import numpy as np


def _ragged_split(n_children: int, n_parents: int, rng) -> np.ndarray:
    """Parent id for each child, with realistically uneven family sizes."""
    weights = rng.dirichlet(np.full(n_parents, 1.5))
    sizes = np.maximum(1, np.round(weights * n_children).astype(int))
    while sizes.sum() > n_children:
        sizes[np.argmax(sizes)] -= 1
    while sizes.sum() < n_children:
        sizes[np.argmin(sizes)] += 1
    return np.repeat(np.arange(n_parents), sizes)


def _zipf_probs(n: int, alpha: float) -> np.ndarray:
    p = 1.0 / np.arange(1, n + 1) ** alpha
    return p / p.sum()


def protocol_corpus(cfg: dict, n_docs: int, seed: int):
    """``(docs, level_labels [coarse..fine], n_train, n_val)`` from the knobs
    ``cfg`` (the keys of the port's ``PROTOCOL_CFGS`` entries)."""
    rng = np.random.default_rng(seed + 7_777)
    levels = tuple(cfg["levels"])
    n_background, pool_size, bg_alpha = (
        cfg["n_background"], cfg["pool_size"], cfg["bg_alpha"]
    )
    mix, child_alpha = cfg["mix"], cfg["child_alpha"]
    log_len, sig_len, min_len, max_len = (
        cfg["log_len"], cfg["sig_len"], cfg["min_len"], cfg["max_len"]
    )
    n_train = int(round(n_docs * cfg["train_frac"]))
    n_val = int(round(n_docs * cfg["val_frac"]))

    bg_words = np.array([f"bg{i:05d}" for i in range(n_background)])
    bg_p = _zipf_probs(n_background, bg_alpha)

    parent_of = []
    for li in range(1, len(levels)):
        parent_of.append(_ragged_split(levels[li], levels[li - 1], rng))

    pools = []
    for li, n_cls in enumerate(levels[:-1]):
        pools.append(
            [
                np.array([f"t{li}c{c:03d}w{j:03d}" for j in range(pool_size)])
                for c in range(n_cls)
            ]
        )
    n_leaf = levels[-1]
    leaf_parent = parent_of[-1]
    child_p = _zipf_probs(pool_size, child_alpha)
    leaf_tilt = cfg["leaf_tilt"]
    leaf_dists = []
    for _ in range(n_leaf):
        w = child_p * np.exp(leaf_tilt * rng.standard_normal(pool_size))
        leaf_dists.append(np.cumsum(w / w.sum()))
    leaf_vocab_size = int(cfg["leaf_vocab_size"])
    if leaf_vocab_size > 0:
        leaf_vocab = [
            np.array([f"leaf{c:03d}w{j:02d}" for j in range(leaf_vocab_size)])
            for c in range(n_leaf)
        ]
        leaf_vocab_p = _zipf_probs(leaf_vocab_size, 1.1)

    leaf_alias = float(cfg["leaf_alias"])
    alias_tilt = cfg["alias_tilt"]
    rank_within = np.zeros(n_leaf, np.int64)
    for p_id in range(levels[-2]):
        members = np.flatnonzero(leaf_parent == p_id)
        rank_within[members] = np.arange(len(members))
    if leaf_alias > 0.0:
        n_ranks = int(rank_within.max()) + 1
        alias_words = np.array([f"alw{j:03d}" for j in range(pool_size)])
        tilt = leaf_tilt if alias_tilt is None else float(alias_tilt)
        rank_dists = []
        for _ in range(n_ranks):
            w = child_p * np.exp(tilt * rng.standard_normal(pool_size))
            rank_dists.append(np.cumsum(w / w.sum()))

    leaf_prior = rng.dirichlet(np.full(n_leaf, float(cfg["prior_alpha"])))

    bg_cum = np.cumsum(bg_p)
    child_cum = np.cumsum(child_p)
    tail_tilt = float(cfg["tail_tilt"])
    tail_scope = str(cfg["tail_scope"])
    if tail_scope not in ("global", "parent"):
        raise ValueError(f"tail_scope must be 'global' or 'parent', got {tail_scope!r}")
    n_leaf_mix = levels[-1]
    mix_arr = np.asarray(mix, np.float64)
    if tail_tilt > 0.0:
        if tail_scope == "parent":
            ref = np.empty(n_leaf_mix)
            for p in np.unique(leaf_parent):
                m = leaf_parent == p
                ref[m] = leaf_prior[m].max()
        else:
            ref = np.full(n_leaf_mix, leaf_prior.max())
        g_mix = (leaf_prior / ref) ** tail_tilt
    else:
        g_mix = np.ones(n_leaf_mix)
    mix_cums = np.empty((n_leaf_mix, len(mix)))
    for c in range(n_leaf_mix):
        m = mix_arr.copy()
        m[-1] = mix_arr[-1] * g_mix[c]
        m[0] = mix_arr[0] + mix_arr[-1] * (1.0 - g_mix[c])
        mix_cums[c] = np.cumsum(m)
    if leaf_vocab_size > 0:
        leaf_cum = np.cumsum(leaf_vocab_p)

    docs = []
    leaf_label = np.searchsorted(np.cumsum(leaf_prior), rng.random(n_docs)).clip(
        0, n_leaf - 1
    )
    lengths = np.clip(
        np.exp(rng.normal(log_len, sig_len, n_docs)).astype(int), min_len, max_len
    )
    for i in range(n_docs):
        leaf = int(leaf_label[i])
        chain = [leaf]
        for po in reversed(parent_of):
            chain.append(int(po[chain[-1]]))
        chain = chain[::-1]
        length = int(lengths[i])
        kind = np.searchsorted(mix_cums[leaf], rng.random(length)).clip(0, len(mix) - 1)
        words = np.empty(length, dtype=object)
        m0 = kind == 0
        if m0.any():
            idx = np.searchsorted(bg_cum, rng.random(int(m0.sum())))
            words[m0] = bg_words[idx.clip(0, n_background - 1)]
        for li in range(len(levels) - 1):
            m = kind == (1 + li)
            if m.any():
                pool = pools[li][chain[li]]
                idx = np.searchsorted(child_cum, rng.random(int(m.sum())))
                words[m] = pool[idx.clip(0, pool_size - 1)]
        m = kind == len(mix) - 1
        if m.any():
            if leaf_vocab_size > 0:
                idx = np.searchsorted(leaf_cum, rng.random(int(m.sum())))
                words[m] = leaf_vocab[leaf][idx.clip(0, len(leaf_vocab_p) - 1)]
            elif leaf_alias > 0.0:
                mi = np.flatnonzero(m)
                take_alias = rng.random(len(mi)) < leaf_alias
                ai = mi[take_alias]
                if len(ai):
                    dist = rank_dists[int(rank_within[leaf])]
                    idx = np.searchsorted(dist, rng.random(len(ai)))
                    words[ai] = alias_words[idx.clip(0, pool_size - 1)]
                pi = mi[~take_alias]
                if len(pi):
                    pool = pools[-1][int(leaf_parent[leaf])]
                    idx = np.searchsorted(leaf_dists[leaf], rng.random(len(pi)))
                    words[pi] = pool[idx.clip(0, pool_size - 1)]
            else:
                pool = pools[-1][int(leaf_parent[leaf])]
                idx = np.searchsorted(leaf_dists[leaf], rng.random(int(m.sum())))
                words[m] = pool[idx.clip(0, pool_size - 1)]
        docs.append(" ".join(words.tolist()))

    noise = float(cfg["label_noise"])
    if noise > 0.0:
        flip = rng.random(n_docs) < noise
        leaf_label = leaf_label.copy()
        leaf_label[flip] = np.searchsorted(
            np.cumsum(leaf_prior), rng.random(int(flip.sum()))
        ).clip(0, n_leaf - 1)

    level_labels = []
    for li in range(len(levels)):
        lab = leaf_label.copy()
        for po in reversed(parent_of[li:]):
            lab = po[lab]
        level_labels.append(lab.astype(np.int64))
    return docs, level_labels, n_train, n_val


def split_blocks(n_train: int, n_val: int, n: int, rng: np.random.Generator,
                 val_split: float = 0.1):
    """``(test_idx, val_idx)`` of a corpus laid out train, [val,] test: test
    is the last block; val is the explicit block between train and test when
    ``n_val`` > 0, else a random ``val_split`` of train drawn from ``rng``
    (flat_amazon.py:51-63)."""
    if n_val:
        return np.arange(n_train + n_val, n), np.arange(n_train, n_train + n_val)
    return np.arange(n_train, n), rng.choice(n_train, int(val_split * n_train), replace=False)


def make_inputs(data: dict, seed: int, n_docs: int = 0):
    """The cell's corpus and split from ``--seed``: ``(docs, y, test_idx,
    val_idx)``, ``y`` the finest level's labels, as the flat driver loads a
    synthetic corpus (experiments/common.py::load_corpus). ``n_docs``
    overrides the configuration's size (the CPU tests' small runs)."""
    docs, level_labels, n_train, n_val = protocol_corpus(
        data["corpus"], n_docs or int(data["n_docs"]), seed)
    test_idx, val_idx = split_blocks(n_train, n_val, len(docs), np.random.default_rng(seed),
                                     float(data["val_split"]))
    return docs, np.asarray(level_labels[-1]), test_idx, val_idx


def class_count(data: dict) -> int:
    """The number of classes of the finest label level."""
    return int(data["corpus"]["levels"][-1])

