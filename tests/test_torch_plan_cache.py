"""The port's plan cache (ops/plan_cache.py, ``--train-plan-cache``): a warm
load gives the cold build's plan bit for bit without building it again,
every build parameter is in the key (the cost model's version too, for
'auto'), and a weight-symmetric graph takes the fast symmetry audit."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.experiments import flat
from pytextgcn_tpu_torch.ops import NormAdj, adjacency, hybrid, plan_cache
from pytextgcn_tpu_torch.ops.spmm import spmm


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sym_graph(seed=0, n_vocab=300, n_docs=200, m=6000, weight_symmetric=True):
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    a = np.minimum(rng.zipf(1.5, m) - 1, n - 1).astype(np.int32)
    b = rng.integers(0, n, m).astype(np.int32)
    w = (rng.random(m) + 0.1).astype(np.float32)
    zeros = np.zeros(n, bool)
    return TextGraph(edge_src=np.concatenate([a, b]), edge_dst=np.concatenate([b, a]),
                     edge_w=np.concatenate([w, w]), y=np.zeros(n, np.int32),
                     train_mask=zeros, val_mask=zeros, test_mask=zeros,
                     n_vocab=n_vocab, n_docs=n_docs, weight_symmetric=weight_symmetric)


def _assert_same_bits(a, b, path="plan"):
    if dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _assert_same_bits(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), path
    else:
        assert a == b, path


def _no_builds(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("a warm load built the plan again")

    monkeypatch.setattr(adjacency, "build_hybrid_plan", boom)
    monkeypatch.setattr(adjacency, "build_plan_from_arrays", boom)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True), dict(hybrid_k=64), dict(hybrid_k=64, hybrid_resid="segment"),
    dict(hybrid_k=128, hybrid_f32_mode="highest", pallas_dtype="bfloat16"),
    dict(hybrid_k="auto", h_hint=16),
], ids=["csr", "hybrid", "hybrid-segment", "hybrid-bf16", "auto"])
def test_round_trip_is_bitwise(tmp_path, monkeypatch, kw):
    g = _sym_graph()
    cache = str(tmp_path / "plans")
    cold = NormAdj.from_graph(g, plan_cache=cache, device="cpu", **kw)
    assert cold.plan is not None and len(os.listdir(cache)) == 1
    _no_builds(monkeypatch)
    warm = NormAdj.from_graph(g, plan_cache=cache, device="cpu", **kw)
    _assert_same_bits(cold.plan, warm.plan)
    x = torch.tensor(np.random.default_rng(3).standard_normal((g.n_nodes, 16)),
                     dtype=torch.float32)
    assert torch.equal(spmm(cold, x), spmm(warm, x))


def test_every_parameter_is_in_the_key(tmp_path):
    g = _sym_graph()
    cache = str(tmp_path / "plans")
    variants = [dict(use_pallas=True), dict(use_pallas=True, pallas_dtype="bfloat16"),
                dict(hybrid_k=64), dict(hybrid_k=128), dict(hybrid_k=64, hybrid_resid="segment"),
                dict(hybrid_k=64, hybrid_f32_mode="highest"),
                dict(hybrid_k=64, hybrid_f32_mode="highest", hybrid_fused=True),
                dict(hybrid_k=64, hybrid_batch=6), dict(hybrid_k=64, h_hint=43)]
    for i, kw in enumerate(variants):
        NormAdj.from_graph(g, plan_cache=cache, device="cpu", **kw)
        assert len(os.listdir(cache)) == i + 1, kw
    NormAdj.from_graph(_sym_graph(seed=9), plan_cache=cache, device="cpu", use_pallas=True)
    assert len(os.listdir(cache)) == len(variants) + 1  # another graph misses too
    NormAdj.from_graph(g, plan_cache=cache, device="cpu")  # the segment path: no plan
    assert len(os.listdir(cache)) == len(variants) + 1


def test_auto_keys_fold_in_the_cost_model_version(monkeypatch):
    fp = plan_cache.graph_fingerprint(np.arange(3), np.arange(3), np.ones(3), 3)
    auto = plan_cache.plan_key(fp, hybrid_k="auto", h_hint=100)
    fixed = plan_cache.plan_key(fp, hybrid_k=4096, h_hint=100)
    monkeypatch.setattr(plan_cache, "COST_MODEL_VERSION", plan_cache.COST_MODEL_VERSION + 1)
    assert plan_cache.plan_key(fp, hybrid_k="auto", h_hint=100) != auto
    assert plan_cache.plan_key(fp, hybrid_k=4096, h_hint=100) == fixed


def test_weight_symmetric_graphs_take_the_fast_audit(tmp_path, monkeypatch):
    g = _sym_graph()
    g.save(str(tmp_path / "g.npz"))
    g2 = TextGraph.load(str(tmp_path / "g.npz"))
    assert g2.weight_symmetric is True
    assert dataclasses.replace(g2, y=np.ones(g2.n_nodes, np.int32)).weight_symmetric is True

    def boom(*a, **k):
        raise AssertionError("the full lexsort audit ran on a flagged graph")

    monkeypatch.setattr(hybrid, "check_weight_symmetric", boom)
    adj = NormAdj.from_graph(g2, hybrid_k=64, plan_cache=str(tmp_path / "plans"),
                             device="cpu")
    assert isinstance(adj.plan, hybrid.HybridPlan)
    with pytest.raises(AssertionError, match="lexsort"):
        NormAdj.from_graph(dataclasses.replace(g2, weight_symmetric=False), hybrid_k=64,
                           device="cpu")


def test_flat_experiment_with_a_plan_cache_twice(tmp_path, monkeypatch):
    cache = str(tmp_path / "plans")
    argv = ["--device", "cpu", "--train-epochs", "6", "--train-verbose", "0",
            "--train-plan-cache", cache, "--train-masked-head", "true"]
    first = flat.main(argv)
    assert len(os.listdir(cache)) == 1
    _no_builds(monkeypatch)
    second = flat.main(argv)
    assert [r["loss"] for r in second["history"]] == [r["loss"] for r in first["history"]]
    assert second["accuracy"] == first["accuracy"]
