"""Edges/s scaling harness: the sharded SpMM over 1, 2 and 4 ranks.

Port of ``experiments/benchmark_scaling.py``: the edge-partitioned
aggregation's throughput as the group grows (the scaling-efficiency
metric), for the 'allgather' partition (``parallel/sharded.py``), the halo
exchange (``parallel/halo.py``) and the sharded hybrid
(``parallel/hybrid_sharded.py``), each forward SpMM on the CSR kernel's
plans; at one rank only 'allgather' runs (nothing to exchange), as in the
JAX script. Each rank count is one group, spawned here: one process a card
over NCCL, or ranks on the CPU over gloo (``--device cpu``). The graph is the
JAX script's synthetic symmetric Zipf + locality graph from
``default_rng(0)``, value for value, or with ``--bench-graph`` the bench's
20,000-document Zipf graph (``pytextgcn_tpu_torch/bench.py``).

Each line: ms a SpMM (the slowest rank's mean over ``--repeats``), Medges/s,
the efficiency against the first line (one rank, 'allgather'), and the
comm model's MB a SpMM a rank (``comm_rows_per_device`` x the row's
bytes). ``--audit-comm``: the JAX script parses the collectives' bytes out
of the compiled HLO, which has no counterpart outside XLA; here the
operators count the rows their collectives move (``wire_rows``), and the
line adds those rows and bytes a SpMM a rank beside the model's.

    python -m pytextgcn_tpu_torch.experiments.benchmark_scaling   # every card, NCCL
    python -m pytextgcn_tpu_torch.experiments.benchmark_scaling --device cpu \\
        --ranks 1 2 --n-nodes 4000 --n-edges 40000 --audit-comm
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..core.graph import TextGraph
from ..utils import resolve_device

MODES = ("allgather", "halo", "hybrid")


def synthetic_graph(n_nodes: int, n_edges: int, local_frac: float,
                    rng: np.random.Generator) -> TextGraph:
    """The JAX script's graph: symmetric pairs (real normalized text
    adjacencies store both directions, which the hybrid's transposed term
    needs) with Zipfian endpoints, whose counterparts land within 2,048
    ids of them with probability ``local_frac`` and uniformly otherwise
    (those form the halo). Draws from ``rng`` in the JAX script's order."""
    n, half = n_nodes, n_edges // 2
    zipf_p = 1.0 / np.arange(1, n + 1, dtype=np.float64) ** 1.05
    zipf_p /= zipf_p.sum()
    a = rng.choice(n, half, p=zipf_p).astype(np.int32)
    local = rng.random(half) < local_frac
    region = 2048
    b = np.where(local, (a + rng.integers(-region, region, half)) % n,
                 rng.integers(0, n, half)).astype(np.int32)
    w_half = (rng.random(half) + 0.05).astype(np.float32)
    none = np.zeros(n, bool)
    return TextGraph(edge_src=np.concatenate([a, b]), edge_dst=np.concatenate([b, a]),
                     edge_w=np.concatenate([w_half, w_half]), y=np.zeros(n, np.int32),
                     train_mask=none, val_mask=none.copy(), test_mask=none.copy(),
                     n_vocab=n // 2, n_docs=n - n // 2)


def inputs(args) -> Tuple[TextGraph, np.ndarray]:
    """The graph and the activation ``x`` ``[N, hidden]``, from
    ``default_rng(0)`` as the JAX script draws them."""
    rng = np.random.default_rng(0)
    g = synthetic_graph(args.n_nodes, args.n_edges, args.local_frac, rng)
    if args.bench_graph:
        from ..bench import build_graph

        g = build_graph(20_000, device=args.device)
    x = rng.standard_normal((g.n_nodes, args.hidden)).astype(np.float32)
    return g, x


def _operator(mode: str, g: TextGraph, mesh, x: torch.Tensor, hot_k, hidden: int):
    """The mode's operator on this rank and its SpMM on ``x`` (replicated
    under 'allgather', the rank's rows otherwise); None for the halo and
    the hybrid at one rank, and when the hybrid has no hot set."""
    from ..parallel import (build_halo_adj, build_hybrid_sharded_adj, build_sharded_adj,
                            spmm_halo, spmm_hybrid_sharded, spmm_sharded)
    from ..parallel.sharded import local_block

    if mode != "allgather" and mesh.world_size == 1:
        return None
    if mode == "allgather":
        adj = build_sharded_adj(g, mesh, use_pallas=True)
        return adj, lambda: spmm_sharded(adj, x)
    if mode == "halo":
        adj = build_halo_adj(g, mesh, use_pallas=True)
        own = local_block(mesh, x, adj.rows_per)
        return adj, lambda: spmm_halo(adj, own)
    if hot_k == "off":
        return None
    adj = build_hybrid_sharded_adj(g, mesh, hot_k=hot_k, h_hint=hidden)
    if adj is None:  # the cost model: no hot set worth it
        return None
    own = local_block(mesh, x, adj.rows_per)
    return adj, lambda: spmm_hybrid_sharded(adj, own)


def _wired(adj) -> list:
    """The operator and its residual halo: what counts ``wire_rows``."""
    return [a for a in (adj, getattr(adj, "halo_res", None)) if a is not None]


def scaling_rank(rank: int, world: int, address: str, backend: str, device: str,
                 data_path: str, hot_k, hidden: int, repeats: int, out_path: str) -> None:
    """One rank of a group (``torch.multiprocessing``): each mode's forward
    SpMM timed ``repeats`` times after a warm-up call, the slowest rank's
    mean kept; rank 0 writes the lines' numbers to ``out_path``."""
    import torch.distributed as dist

    from ..parallel import init_distributed, make_mesh

    if device == "cpu":  # the ranks split the cores
        torch.set_num_threads(max(1, min(2, (os.cpu_count() or 1) // world)))
    init_distributed(address, world, rank, backend=backend, device=device, timeout_s=600)
    mesh = make_mesh(world, device=device)
    on_card = mesh.device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(mesh.device)) if on_card else (lambda: None)
    with np.load(data_path) as z:
        g = TextGraph(**{k: z[k] for k in z.files if k != "x"})
        x = torch.as_tensor(z["x"], device=mesh.device)
    rows = []
    with torch.no_grad():
        for mode in MODES:
            built = _operator(mode, g, mesh, x, hot_k, hidden)
            if built is None:
                continue
            adj, fn = built
            fn()  # warm-up
            for a in _wired(adj):
                a.wire_rows = 0
            sync()
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(repeats):
                fn()
            sync()
            dt = torch.tensor([(time.perf_counter() - t0) / repeats], dtype=torch.float64,
                              device=mesh.device)
            dist.all_reduce(dt, op=dist.ReduceOp.MAX)
            rows.append({"ranks": world, "mode": mode, "seconds": float(dt),
                         "comm_rows": int(adj.comm_rows_per_device),
                         "wire_rows": sum(a.wire_rows for a in _wired(adj)) / repeats,
                         "k": int(getattr(adj, "k", 0))})
            del adj, fn
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump(rows, f)
    dist.barrier()
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(argv: Optional[List[str]] = None) -> List[dict]:
    """Prints a line a rank count and mode, then the rows as one JSON
    line; returns the rows."""
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--n-nodes", type=int, default=50_000)
    p.add_argument("--n-edges", type=int, default=1_000_000)
    p.add_argument("--hidden", type=int, default=128)
    p.add_argument("--repeats", type=int, default=10)
    p.add_argument("--ranks", type=int, nargs="+", default=None,
                   help="rank counts (default: 1, 2, 4, up to the visible cards on a card)")
    p.add_argument("--local-frac", type=float, default=0.8,
                   help="fraction of edges whose counterpart lies within 2,048 ids "
                        "(0 = uniform random)")
    p.add_argument("--hot-k", default="2048",
                   help="'off' | 'auto' | int: the sharded hybrid's hot-set size")
    p.add_argument("--audit-comm", action="store_true",
                   help="add the rows and bytes the collectives moved a SpMM a rank "
                        "(the operators' wire_rows) beside the comm model's")
    p.add_argument("--bench-graph", action="store_true",
                   help="the bench's 20,000-document Zipf graph instead of the synthetic one")
    p.add_argument("--device", default=None,
                   help="'cpu': ranks over gloo; default: the cards, one rank each over NCCL")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    counts = args.ranks or [d for d in (1, 2, 4)
                            if dev.type == "cpu" or d <= torch.cuda.device_count()]
    if dev.type == "cuda" and max(counts) > torch.cuda.device_count():
        raise SystemExit(f"--ranks {max(counts)}: {torch.cuda.device_count()} card(s) "
                         "visible, and NCCL takes one rank a card")
    hot_k = args.hot_k if args.hot_k in ("off", "auto") else int(args.hot_k)
    g, x = inputs(args)
    e, row_bytes = g.n_edges, args.hidden * 4
    results, base_rate = [], None
    with tempfile.TemporaryDirectory() as tmp:
        data_path = os.path.join(tmp, "inputs.npz")
        np.savez(data_path, x=x, **{k: getattr(g, k) for k in (
            "edge_src", "edge_dst", "edge_w", "y", "train_mask", "val_mask", "test_mask",
            "n_vocab", "n_docs")})
        for d in counts:
            out_path = os.path.join(tmp, f"ranks{d}.json")
            torch.multiprocessing.spawn(
                scaling_rank, nprocs=d, join=True,
                args=(d, f"127.0.0.1:{_free_port()}", backend, str(dev), data_path, hot_k,
                      args.hidden, args.repeats, out_path))
            with open(out_path) as f:
                rows = json.load(f)
            for row in rows:
                rate = e / row["seconds"]
                base_rate = base_rate or rate
                row.update(ms=row["seconds"] * 1e3, medges_s=rate / 1e6,
                           efficiency=rate / (base_rate * d),
                           model_mb=row["comm_rows"] * row_bytes / 1e6,
                           wire_mb=row["wire_rows"] * row_bytes / 1e6, n_edges=e,
                           device=str(dev))
                audit = ""
                if args.audit_comm:
                    audit = (f"  | wire/rank {row['wire_rows']:.0f} rows, "
                             f"{row['wire_mb']:.2f} MB (model {row['comm_rows']} rows)")
                print(f"ranks={d} {row['mode']:9s}: {row['ms']:8.2f} ms  "
                      f"{row['medges_s']:8.2f} Medges/s  eff {row['efficiency'] * 100:5.1f}%  "
                      f"model comm/rank {row['model_mb']:7.2f} MB/SpMM{audit}", flush=True)
                results.append(row)
    print(json.dumps({"scaling": results}), flush=True)
    return results


if __name__ == "__main__":
    main()
