"""The port's bench (``python -m pytextgcn_tpu_torch.bench``) against the
JAX package's root ``bench.py``: the same corpus and graph, the same output
keys, and every failure fatal. On the CPU the numbers are the CPU's."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch import bench

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX bench's output line (bench.py:399-433, its probe and
# plan-cache fields included)
JAX_KEYS = {
    "metric", "value", "unit", "vs_baseline", "fraction_of_roofline",
    "fraction_of_achievable", "probed_gather_ns", "probed_hbm_bps", "probed_stream_bps",
    "fraction_of_roofline_probed", "probed_mxu_f32_fps", "probed_mxu_bf16_fps", "probe_s",
    "fraction_of_achievable_probed", "floor_check", "plan_cold_s", "plan_warm_s",
    "masked_head_speedup", "hybrid_k", "x_of_gather_floor", "best_path", "graph", "step_ms",
    "step_ms_spread", "timing_blocks", "step_ms_small", "session",
}
# the subprocesses' threads, for the same reason as _two_threads
FEW_THREADS = dict(os.environ, OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_bench():
    spec = importlib.util.spec_from_file_location("jax_root_bench", os.path.join(ROOT, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_zipf_corpus_equals_jax(jax_bench):
    for n in (1, 50, 300):
        assert bench.zipf_corpus(n) == jax_bench.zipf_corpus(n)
    assert bench.zipf_corpus(40, v_draw=500, alpha=1.3, seed=3) == jax_bench.zipf_corpus(
        40, v_draw=500, alpha=1.3, seed=3)


def test_build_graph_equals_jax(jax_bench):
    g = bench.build_graph(300, device="cpu")
    want = jax_bench.build_graph(300)
    assert (g.n_nodes, g.n_edges, g.n_vocab) == (want.n_nodes, want.n_edges, want.n_vocab)
    for f in ("edge_src", "edge_dst", "edge_w", "y", "train_mask"):
        np.testing.assert_array_equal(getattr(g, f), np.asarray(getattr(want, f)), err_msg=f)


def test_bench_prints_one_line_with_the_jax_keys(tmp_path):
    r = subprocess.run([sys.executable, "-m", "pytextgcn_tpu_torch.bench", "--device", "cpu",
                        "--scales", "200", "--epochs", "1"],
                       cwd=ROOT, env=FEW_THREADS, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    lines = r.stdout.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert JAX_KEYS <= set(out), JAX_KEYS - set(out)
    names = [name for name, _ in bench.variants(None)]
    assert set(out["step_ms"]) == set(names) == set(out["step_ms_small"])
    assert len(names) == 14 and all(len(v) == 3 for v in out["step_ms_spread"].values())
    assert [s["scale"] for s in out["scales"]] == ["200"]
    # every hybrid variant reports its K; the explicit ones are clamped to N
    assert set(out["hybrid_k"]) == {n for n in names if n.startswith("hybrid")}
    assert out["hybrid_k"]["hybrid f32 K4096"] > 0
    assert out["floor_check"] == "ok" and out["session"]["device"] == "cpu"
    assert not bench.check_fractions(out)


def test_a_failing_variant_stops_the_run(monkeypatch):
    monkeypatch.setattr(bench, "variants", lambda cache: [
        ("broken", dict(hybrid_k=64, hybrid_f32_mode="nonsense"))])
    with pytest.raises(ValueError, match="f32_mode"):
        bench.main(["--device", "cpu", "--scales", "200", "--epochs", "1"])


def test_fractions_above_the_limit_fail():
    ok = {"fraction_of_roofline": 0.07, "fraction_of_roofline_probed": 1.05,
          "fraction_of_achievable": None, "fraction_of_achievable_probed": 0.4,
          "floor_check": "ok"}
    assert bench.check_fractions(ok) == []
    bad = dict(ok, fraction_of_achievable=1.2, floor_check="VIOLATED")
    msgs = bench.check_fractions(bad)
    assert len(msgs) == 2 and "fraction_of_achievable=1.2" in msgs[0]


def test_floors_are_held_against_the_busy_time():
    from types import SimpleNamespace

    from pytextgcn_tpu_torch.ops.probe import ChipProbe

    plan = SimpleNamespace(n_nodes=77_923, k=4096, n_resid=1_550_390, compute_dtype="float32",
                           fused=False, d_lo=object())
    pr = ChipProbe(gather_ns=0.23, hbm_bps=2.4e12, mxu_f32_fps=5e13, mxu_bf16_fps=7e14,
                   probe_s=1.0, stream_bps=2.8e12)
    floor_ns = 2 * pr.hybrid_floor_ns(plan, 100) + 2 * pr.hybrid_floor_ns(plan, 43)
    g = SimpleNamespace(n_nodes=77_923, n_edges=13_310_312)

    def line(step_ms, busy_ms):
        name = "hybrid f32 K4096"
        res = {"step_s": {name: step_ms * 1e-3}, "spread": {name: [step_ms * 1e-3] * 3},
               "plans": {name: plan}, "floor_ns": {name: floor_ns}, "hybrid_k": {name: 4096},
               "launches_per_step": {}, "busy": {name: {"busy_ms": busy_ms}} if busy_ms else {}}
        return bench.headline(g, res, res, pr, torch.device("cpu"), {}, [])

    host_only = line(7.0, None)
    assert "fraction_of_achievable_busy" not in host_only and host_only["floor_check"] == "ok"
    out = line(7.0, 3.0)
    floor_ms = floor_ns * 1e-6
    assert out["fraction_of_achievable_busy"] == round(floor_ms / 3.0, 4)
    assert out["fraction_of_achievable_probed_busy"] == round(floor_ms / 3.0, 4)
    assert out["fraction_of_achievable_probed"] == round(floor_ms / 7.0, 4)
    assert out["floor_check"] == "ok" and not bench.check_fractions(out)
    # a floor above the device's busy time fails the run, whatever the host's step
    out = line(7.0, floor_ms / 1.2)
    assert out["floor_check"] == "VIOLATED"
    assert any("fraction_of_achievable_busy" in m for m in bench.check_fractions(out))


def test_expected_launches_follow_the_plans():
    from pytextgcn_tpu_torch.core.graph import TextGraph
    from pytextgcn_tpu_torch.ops import NormAdj
    from pytextgcn_tpu_torch.ops.restricted import build_restricted_adj

    rng = np.random.default_rng(0)
    n, m = 300, 3000
    a, b = rng.integers(0, n, m), rng.integers(0, n, m)
    w = (rng.random(m) + 0.1).astype(np.float32)
    zeros = np.zeros(n, bool)
    g = TextGraph(edge_src=np.concatenate([a, b]).astype(np.int32),
                  edge_dst=np.concatenate([b, a]).astype(np.int32),
                  edge_w=np.concatenate([w, w]), y=np.zeros(n, np.int32),
                  train_mask=zeros, val_mask=zeros, test_mask=zeros, n_vocab=150, n_docs=150)
    adj = lambda **kw: NormAdj.from_graph(g, device="cpu", **kw)
    out = build_restricted_adj(g, np.arange(150, 300), use_pallas=True, device="cpu")
    exp = bench.expected_launches
    assert exp(adj(), None) == {"spmm_csr": 0, "dual": {}}
    assert exp(adj(use_pallas=True), None) == {"spmm_csr": 4, "dual": {}}
    assert exp(adj(hybrid_k=128), None) == {"spmm_csr": 4, "dual": {"split": 4}}
    assert exp(adj(hybrid_k=128), out) == {"spmm_csr": 4, "dual": {"split": 2}}
    assert exp(adj(hybrid_k=128, pallas_dtype="bfloat16"), None)["dual"] == {"bf16": 4}
    assert exp(adj(hybrid_k=128, hybrid_f32_mode="highest"), None)["dual"] == {}
    assert exp(adj(hybrid_k=128, hybrid_f32_mode="highest", hybrid_fused=True),
               None)["dual"] == {"f32": 4}
