"""Protocol-scale runs of the port, for the comparison with the JAX
package's seed spreads.

The port's side of ``experiments/protocol_parity.py``: the reference's
protocols (flat_amazon.py:20-35 / flat_dbpedia.py:18-34 and their
hierarchy drivers) on the protocol-scale synthetic corpora, with the same
graph knobs, per-seed masks and trainer settings, on the CSR kernel path
in full f32 (TF32 off). The graph is built once per protocol and
hierarchy; each seed redraws the masks. Rows go to the reference's
results.csv schema with category ``torch-cuda`` (``torch-cpu`` for a run on
the CPU). ``--masked-head`` (flat:
the train rows' head, ops/restricted.py) and ``--ep`` (per-label: the
batched ensemble, as ``experiments/protocol_parity.py --ep``) tag their
rows' hierarchy ``flat masked-head`` and ``per-label ep``. ``--model mlp``
is the TF-IDF + MLP baseline of ``experiments/mlp_parity.py`` (no graph: a
seeded 10% validation draw, the fixed test block, the finest level, 500
epochs with the patience stop), its first layer on the CSR kernel.

    python -m pytextgcn_tpu_torch.experiments.protocol --protocol amazon \\
        --model gcn --hierarchy flat --seeds 42 43 44
    python -m pytextgcn_tpu_torch.experiments.protocol --protocol dbpedia \\
        --hierarchy perlevel
    python -m pytextgcn_tpu_torch.experiments.protocol --device cpu --n-docs 2000 \\
        --epochs 5 --out "$(mktemp -d)/rows.csv"   # a small run on the CPU
    python -m pytextgcn_tpu_torch.experiments.protocol --protocol amazon \
        --hierarchy perlabel --ep
    python -m pytextgcn_tpu_torch.experiments.protocol --protocol dbpedia --model mlp
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from ..baselines import mlp_flat
from ..config import GraphConfig, ModelConfig, make_model
from ..data.synthetic import protocol_corpus
from ..hierarchy import eval_per_label, train_per_label, train_per_level
from ..train.results import append_result
from ..train.trainer import Trainer
from ..utils import resolve_device
from .common import build_graph as build_corpus_graph
from .common import exact_f32, split_blocks
from .mlp import tfidf_splits

# the flat protocols, verbatim (flat_amazon.py:20-35; flat_dbpedia.py:18-34).
# ``hier_max_df``: the hierarchy drivers build their graphs with max_df=0.6
# (perlevel_amazon.py:16-27, perlabel_amazon.py:13-40); dbpedia's cascade
# keeps the flat knobs (perlevel_dbpedia.py:16-28).
PROTOCOLS = {
    "amazon": dict(
        min_df=5, max_df=0.7, window_size=20, max_length=None,
        epochs=500, lr=0.05, dropout=0.7, n_hidden=100, hier_max_df=0.6,
    ),
    "dbpedia": dict(
        min_df=100, max_df=0.4, window_size=5, max_length=15,
        epochs=100, lr=0.05, dropout=0.5, n_hidden=32, hier_max_df=0.4,
    ),
}
CATEGORY = {"cuda": "torch-cuda", "cpu": "torch-cpu"}  # rows of a CPU run say so
HIERARCHY_NAMES = {"flat": "flat", "perlevel": "per-level", "perlabel": "per-label"}


def build_graph(protocol: str, n_docs: int, verbose: int = 1, hierarchy: str = "flat",
                device=None):
    """``(graph, level_labels, n_train, n_val)``; the graph's masks are
    placeholders for :func:`remask`."""
    p = PROTOCOLS[protocol]
    docs, level_labels, n_train, n_val = protocol_corpus(protocol, n_docs=n_docs)
    gcfg = GraphConfig(min_df=p["min_df"],
                       max_df=p["max_df"] if hierarchy == "flat" else p["hier_max_df"],
                       window_size=p["window_size"], max_length=p["max_length"],
                       rm_stopwords=False)
    t0 = time.time()
    g = build_corpus_graph(gcfg, docs, np.asarray(level_labels[-1]),
                           np.arange(n_train + n_val, len(docs)), np.arange(0), verbose,
                           device=device)
    if verbose:
        print(f"[{protocol}] graph: N={g.n_nodes} (vocab {g.n_vocab}) E={g.n_edges} "
              f"built in {time.time() - t0:.1f}s", flush=True)
    return g, [np.asarray(l) for l in level_labels], n_train, n_val


def remask(g, protocol: str, n_train: int, n_val: int, seed: int):
    """Per-seed split masks with the reference drivers' semantics."""
    n = g.n_nodes
    test_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    rng = np.random.default_rng(seed)
    if protocol == "amazon":
        val_docs = rng.choice(n_train, int(0.1 * n_train), replace=False)
        val_mask[g.n_vocab + val_docs] = True
        test_mask[g.n_vocab + n_train:] = True
    else:
        val_mask[g.n_vocab + n_train: g.n_vocab + n_train + n_val] = True
        test_mask[g.n_vocab + n_train + n_val:] = True
    train_mask = ~(test_mask | val_mask)
    train_mask[: g.n_vocab] = False  # word nodes carry pseudo-labels only
    return dataclasses.replace(g, train_mask=train_mask, val_mask=val_mask,
                               test_mask=test_mask)


def model_factory(model: str, p: dict, generator: torch.Generator):
    """The protocol's model through ``make_model``: EGCN takes the
    reference's embedding_dim=2000 (models.py:35)."""
    mcfg = ModelConfig(model=model, n_hidden=p["n_hidden"], dropout=p["dropout"],
                       embedding_dim=2000)
    return lambda i, o: make_model(mcfg, i, o, generator)


def mlp_splits(corpus, seed: int):
    """``experiments/mlp_parity.py::build_splits``: a random 10% of train as
    validation drawn from ``default_rng(seed)`` (amazon; dbpedia's explicit
    block), the test block fixed, TF-IDF fit on the train split."""
    docs, level_labels, n_train, n_val = corpus
    test_idx, val_idx = split_blocks(n_train, n_val, len(docs), np.random.default_rng(seed))
    return tfidf_splits(docs, level_labels, test_idx, val_idx)


def run_seed(args, p, gs, level_labels, seed, device, prev):
    """One seed of the configuration. Returns (metrics, a trainer whose
    operator the next seed may adopt, or None)."""
    if args.model == "mlp":
        splits = mlp_splits(gs, seed)
        m = mlp_flat(splits, len(splits.y_train) - 1, epochs=p["epochs"], seed=seed,
                     device=device, verbose=0)
        return {"accuracy": m["accuracy"], "f1_macro": m["f1_macro"],
                "epochs_ran": len(m["history"])}, None
    factory = model_factory(args.model, p, torch.Generator().manual_seed(seed))
    if args.hierarchy == "flat":
        n_classes = int(np.max(gs.y)) + 1
        tr = Trainer(factory(gs.in_dim, n_classes), lr=p["lr"], seed=seed, device=device,
                     masked_head=args.masked_head)
        if prev is not None:
            # remask only redraws masks: the operator is the same
            tr.share_adjacency(prev)
        hist = tr.fit(gs, epochs=p["epochs"], n_classes=n_classes, verbose=args.verbose,
                      eval_every=max(1, p["epochs"] // 10))
        m = tr.evaluate(gs, n_classes=n_classes)
        m["final_loss"] = hist[-1]["loss"]
        return m, tr
    tkw = {"device": device}
    if args.hierarchy == "perlevel":
        res = train_per_level(gs, level_labels, factory, lr=p["lr"], epochs=p["epochs"],
                              seed=seed, verbose=args.verbose, trainer_kwargs=tkw)
        return dict(res["metrics"]), None
    y_child, y_parent = level_labels[-1], level_labels[-2]
    ens = train_per_label(gs, y_child, y_parent, factory, lr=p["lr"], epochs=p["epochs"],
                          seed=seed, verbose=args.verbose, trainer_kwargs=tkw, ep=args.ep)
    # ground-truth routing is the reference quirk (eval_perlabel.py:73)
    m = eval_per_label(gs, y_child, y_parent, ens["trainers"], ens["mapping"],
                       route="ground_truth")
    return {k: m[k] for k in ("accuracy", "f1_macro")}, None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--protocol", choices=list(PROTOCOLS), default="amazon")
    ap.add_argument("--model", choices=["gcn", "egcn", "jk", "mlp"], default="gcn")
    ap.add_argument("--hierarchy", choices=list(HIERARCHY_NAMES), default="flat")
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    ap.add_argument("--n-docs", type=int, default=0, help="0 = the protocol's size")
    ap.add_argument("--epochs", type=int, default=0,
                    help="0 = the protocol's epoch count (set it for smoke runs)")
    ap.add_argument("--out", default="docs/protocol_results_port.csv")
    ap.add_argument("--device", default=None, help="default: the GPU (raises without one)")
    ap.add_argument("--masked-head", action="store_true",
                    help="flat: aggregate the final layer into the train rows only")
    ap.add_argument("--ep", action="store_true",
                    help="per-label: train the members in one batched step")
    ap.add_argument("--verbose", type=int, default=1)
    args = ap.parse_args(argv)
    if args.masked_head and args.hierarchy != "flat":
        ap.error("--masked-head runs the flat protocol only")
    if args.ep and args.hierarchy != "perlabel":
        ap.error("--ep runs the per-label protocol only")
    if args.model == "mlp" and (args.hierarchy != "flat" or args.masked_head):
        ap.error("--model mlp runs the flat protocol only")

    device = resolve_device(args.device)
    exact_f32()
    p = dict(PROTOCOLS[args.protocol])
    if args.model == "mlp":
        p["epochs"] = 500  # experiments/mlp_parity.py, whatever the protocol's GCN count
    if args.epochs:
        p["epochs"] = args.epochs
    n_docs = args.n_docs or (50_000 if args.protocol == "amazon" else 60_000)
    if args.model == "mlp":
        corpus = protocol_corpus(args.protocol, n_docs=n_docs)
        g, level_labels, n_train, n_val = None, None, corpus[2], corpus[3]
    else:
        g, level_labels, n_train, n_val = build_graph(args.protocol, n_docs, args.verbose,
                                                      hierarchy=args.hierarchy, device=device)
    hier = HIERARCHY_NAMES[args.hierarchy] + (" masked-head" if args.masked_head else "") + (
        " ep" if args.ep else "")
    rows, prev = [], None
    for seed in args.seeds:
        # the MLP has no graph: its seed redraws the split from the corpus
        gs = corpus if g is None else remask(g, args.protocol, n_train, n_val, seed)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.time()
        m, prev = run_seed(args, p, gs, level_labels, seed, device, prev)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            m["peak_memory_gb"] = torch.cuda.max_memory_allocated(device) / 1e9
        m["seconds"] = time.time() - t0
        m["seed"] = seed
        rows.append(m)
        print(f"[{args.protocol} {args.model} {hier} seed={seed}] acc {m['accuracy']:.4f} "
              f"f1 {m['f1_macro']:.4f} ({m['seconds']:.1f}s"
              + (f", peak {m['peak_memory_gb']:.2f} GB" if "peak_memory_gb" in m else "")
              + ")", flush=True)
        append_result(args.out, seed=seed, model=args.model.upper(), hierarchy=hier,
                      f1_macro=m["f1_macro"], accuracy=m["accuracy"],
                      dataset=f"synthetic-{args.protocol}", category=CATEGORY[device.type])
    accs = [m["accuracy"] for m in rows]
    f1s = [m["f1_macro"] for m in rows]
    print(json.dumps({
        "protocol": args.protocol, "model": args.model, "hierarchy": hier,
        "n_docs": n_docs, "n_nodes": g.n_nodes if g is not None else None,
        "n_edges": g.n_edges if g is not None else None, "epochs": p["epochs"],
        "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "summary": {"accuracy": [float(np.mean(accs)), float(np.std(accs))],
                    "f1_macro": [float(np.mean(f1s)), float(np.std(f1s))]},
        "runs": rows,
    }), flush=True)
    return rows


if __name__ == "__main__":
    main()
