"""Graph-construction benchmark: the corpus -> graph pipeline without
training, timed for each word-word counting backend.

Port of ``experiments/benchmark_graph.py``: the ``native`` (threaded C++)
and ``device`` (sort and unique on the card) backends on the small
synthetic corpus or an open-vocabulary Zipf corpus, and with
``--plan-bench`` the hybrid plan built cold and loaded warm through the
plan cache. Every backend must give the same edges bit for bit. The
``sharded`` backend is not ported (ROADMAP.md §1 item 4c).

    python -m pytextgcn_tpu_torch.experiments.benchmark_graph --n-docs 2000
    python -m pytextgcn_tpu_torch.experiments.benchmark_graph --device cpu \\
        --corpus zipf --n-docs 1000 --plan-bench
"""

from __future__ import annotations

import argparse
import json
import shutil
import tempfile
import time

import numpy as np

from ..build.text2graph import Text2Graph
from ..data.synthetic import synthetic_corpus
from ..utils import resolve_device

BACKENDS = ("native", "device")
SHARDED_REFUSED = ("--backends sharded: not ported to pytextgcn_tpu_torch yet "
                   "(see ROADMAP.md §1 item 4c)")


def zipf_docs(n_docs: int, v_draw: int, n_classes: int):
    """The JAX driver's open-vocabulary Zipf corpus, value for value."""
    rng = np.random.default_rng(0)
    p_w = 1.0 / np.arange(1, v_draw + 1) ** 1.05
    cum = np.cumsum(p_w / p_w.sum())
    lengths = np.clip(np.exp(rng.normal(3.9, 0.5, n_docs)).astype(int), 8, 300)
    docs = []
    for i in range(n_docs):
        idx = np.searchsorted(cum, rng.random(lengths[i])).clip(0, v_draw - 1)
        docs.append(" ".join(f"w{j}" for j in idx))
    return docs, list(rng.integers(0, n_classes, n_docs))


def main(argv=None) -> dict:
    """Returns ``{"backends": [...], "edges_equal": bool, "plan": {...}}``."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-docs", type=int, default=2000)
    p.add_argument("--n-classes", type=int, default=10)
    p.add_argument("--window-size", type=int, default=20)
    p.add_argument("--min-df", type=int, default=1)
    p.add_argument("--backends", nargs="+", default=list(BACKENDS),
                   help="counting backends to time: native, device")
    p.add_argument("--corpus", choices=["classes", "zipf"], default="classes",
                   help="'zipf': an open-vocabulary Zipfian corpus (with --min-df 1 and "
                        "--v-draw, large vocabularies)")
    p.add_argument("--v-draw", type=int, default=120_000,
                   help="zipf corpus: distinct word surfaces drawn from")
    p.add_argument("--plan-bench", action="store_true",
                   help="also time the hybrid plan ('auto' K): cold build against warm "
                        "load through the plan cache (ops/plan_cache.py)")
    p.add_argument("--device", default=None,
                   help="where device counting and the plans run (default: the GPU)")
    args = p.parse_args(argv)
    if "sharded" in args.backends:
        raise SystemExit(SHARDED_REFUSED)
    unknown = sorted(set(args.backends) - set(BACKENDS))
    if unknown:
        p.error(f"unknown backends {unknown}: choose from {list(BACKENDS)}")
    device = resolve_device(args.device)

    if args.corpus == "zipf":
        docs, labels = zipf_docs(args.n_docs, args.v_draw, args.n_classes)
    else:
        docs, labels = synthetic_corpus(
            n_docs=args.n_docs, n_classes=args.n_classes,
            vocab_per_class=120, shared_vocab=800, doc_len=(30, 180), seed=0,
        )
    test_idx = np.arange(len(docs) - len(docs) // 5, len(docs))
    rows, graphs = [], []
    for backend in args.backends:
        t0 = time.perf_counter()
        t2g = Text2Graph(min_df=args.min_df, window_size=args.window_size, backend=backend,
                         device=device)
        g = t2g.fit_transform(docs, labels, test_idx=test_idx)
        dt = time.perf_counter() - t0
        graphs.append(g)
        rows.append({"backend": backend, "seconds": dt, "n_edges": g.n_edges,
                     "n_vocab": g.n_vocab})
        print(f"backend={backend}: {dt:.2f}s total, {g.n_edges} edges, "
              f"{g.n_vocab} vocab, {g.n_edges / dt / 1e6:.2f} Medges/s end-to-end", flush=True)
    g = graphs[0]
    edges_equal = all(
        all(np.array_equal(getattr(g, f), getattr(other, f))
            for f in ("edge_src", "edge_dst", "edge_w"))
        for other in graphs[1:])
    if not edges_equal:
        raise RuntimeError("the counting backends gave different edges")
    out = {"device": str(device), "backends": rows, "edges_equal": edges_equal}

    if args.plan_bench:
        from ..ops import NormAdj

        cache = tempfile.mkdtemp(prefix="planbench-")
        try:
            t0 = time.perf_counter()
            cold = NormAdj.from_graph(g, hybrid_k="auto", plan_cache=cache, device=device)
            t_cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            warm = NormAdj.from_graph(g, hybrid_k="auto", plan_cache=cache, device=device)
            t_warm = time.perf_counter() - t0
        finally:
            shutil.rmtree(cache, ignore_errors=True)
        k = getattr(cold.plan, "k", 0)
        if type(cold.plan) is not type(warm.plan) or getattr(warm.plan, "k", 0) != k:
            raise RuntimeError("the warm plan differs from the cold build")
        out["plan"] = {"k": k, "cold_s": t_cold, "warm_s": t_warm}
        print(f"hybrid plan (E={g.n_edges}, K={k}): cold build {t_cold:.2f}s, "
              f"warm load {t_warm:.2f}s", flush=True)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
