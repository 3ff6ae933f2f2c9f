"""The port's scaling harness (``pytextgcn_tpu_torch/experiments/
benchmark_scaling.py``) against the JAX script ``experiments/
benchmark_scaling.py``: the same synthetic graph bit for bit, and a tiny run
at 1 and 2 ranks over gloo whose lines carry the rows the collectives
moved, equal to the comm model's."""

import os
import sys

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch.experiments import benchmark_scaling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))

ARGS = ["--n-nodes", "3000", "--n-edges", "30000", "--hidden", "8", "--repeats", "2",
        "--hot-k", "256"]


class _Captured(Exception):
    pass


def _jax_graph(monkeypatch, argv):
    """The graph the JAX script builds for ``argv`` (its first operator's
    argument; the run stops there)."""
    import benchmark_scaling as jax_scaling

    import pytextgcn_tpu.parallel as jax_parallel

    seen = []

    def capture(g, mesh, *args, **kwargs):
        seen.append(g)
        raise _Captured

    monkeypatch.setattr(jax_parallel, "build_sharded_adj", capture)
    with pytest.raises(_Captured):
        jax_scaling.main(argv + ["--devices", "1"])
    return seen[0]


@pytest.mark.parametrize("local_frac", ["0.8", "0.0"])
def test_synthetic_graph_is_the_jax_script_s(monkeypatch, local_frac):
    argv = ARGS + ["--local-frac", local_frac]
    want = _jax_graph(monkeypatch, argv)
    ns = type("Args", (), dict(n_nodes=3000, n_edges=30000, local_frac=float(local_frac),
                               bench_graph=False, hidden=8, device="cpu"))
    g, x = benchmark_scaling.inputs(ns)
    for f in ("edge_src", "edge_dst", "edge_w"):
        got, ref = np.asarray(getattr(g, f)), np.asarray(getattr(want, f))
        assert got.dtype == ref.dtype and got.tobytes() == ref.tobytes(), f
    assert (g.n_vocab, g.n_docs, g.n_nodes) == (want.n_vocab, want.n_docs, want.n_nodes)
    # x continues the same generator after the graph's draws
    rng = np.random.default_rng(0)
    benchmark_scaling.synthetic_graph(3000, 30000, float(local_frac), rng)
    assert x.tobytes() == rng.standard_normal((3000, 8)).astype(np.float32).tobytes()


def test_tiny_run_on_one_and_two_ranks_moves_the_modelled_rows(capsys):
    n = torch.get_num_threads()
    try:
        rows = benchmark_scaling.main(ARGS + ["--device", "cpu", "--ranks", "1", "2",
                                              "--audit-comm"])
    finally:
        torch.set_num_threads(n)
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("ranks=")]
    # one line a mode: 'allgather' alone at one rank (nothing to exchange)
    assert [(r["ranks"], r["mode"]) for r in rows] == [
        (1, "allgather"), (2, "allgather"), (2, "halo"), (2, "hybrid")]
    assert len(lines) == len(rows) and all("| wire/rank" in ln for ln in lines)
    assert rows[0]["efficiency"] == 1.0 and rows[-1]["k"] == 256
    for r in rows:
        assert r["ms"] > 0 and r["medges_s"] > 0 and r["n_edges"] == 30000
        assert r["wire_rows"] == r["comm_rows"], r
        assert r["wire_mb"] == r["model_mb"] == r["comm_rows"] * 8 * 4 / 1e6
    assert rows[1]["comm_rows"] == 1500  # (D - 1) * rows_per
    assert rows[2]["comm_rows"] > 0 and rows[3]["comm_rows"] > 0
