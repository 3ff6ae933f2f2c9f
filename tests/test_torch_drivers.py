"""The port's last single-device drivers: ``experiments/hyperopt.py``
(against the JAX driver's folds and smokes), ``experiments/benchmark_graph.py``,
the protocol driver's hybrid flags, and ``utils.tune_allocator``."""

import csv
import math
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch.experiments import benchmark_graph, hyperopt, protocol

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "experiments"))


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,k,seed", [(10, 3, 0), (301, 3, 42), (7, 2, 5), (100, 5, 1)])
def test_kfold_indices_equal_jax(n, k, seed):
    import hyperopt as jax_hyperopt

    got = hyperopt.kfold_indices(n, k, np.random.default_rng(seed))
    want = jax_hyperopt.kfold_indices(n, k, np.random.default_rng(seed))
    assert len(got) == len(want) == k
    for (tr, te), (tr_w, te_w) in zip(got, want):
        np.testing.assert_array_equal(tr, tr_w)
        np.testing.assert_array_equal(te, te_w)
        assert sorted(np.concatenate([tr, te]).tolist()) == list(range(n))


# ---------------------------------------------------------------- what the drivers feed
GRAPH_FIELDS = ("edge_src", "edge_dst", "edge_w", "y", "train_mask", "val_mask", "test_mask",
                "hierarchy_feats")
TRAINER_KEYS = ("optimizer", "hybrid_k", "hybrid_f32_mode", "pallas_dtype", "plan_cache")


def _model_recorder(name):
    """A model class stand-in: records the driver's arguments, builds nothing."""
    def make(in_dim, out_dim, n_hidden_gcn, dropout, **kw):
        return SimpleNamespace(spec=(name, in_dim, out_dim, n_hidden_gcn, dropout))

    return make


def _trainer_recorder(calls):
    """A ``Trainer`` stand-in that records what a driver gives it, for each
    trainer it makes, and trains nothing: ``fit`` returns one finite loss,
    ``evaluate`` scores computed from the evaluated rows' labels, so that
    two drivers given the same rows write the same results."""

    class Recorder:
        def __init__(self, model, lr, seed, **kw):
            self.rec = {"model": getattr(model, "spec", type(model).__name__), "lr": lr,
                        "seed": seed, "shares": False, **{k: kw.get(k) for k in TRAINER_KEYS}}
            calls.append(self.rec)

        def share_adjacency(self, other):
            self.rec["shares"] = True

        def fit(self, g, epochs, n_classes, verbose=0, eval_every=None, **kw):
            self.rec.update(epochs=epochs, n_classes=n_classes, in_dim=g.in_dim,
                            eval_every=eval_every, n_vocab=g.n_vocab)
            for f in GRAPH_FIELDS:
                v = getattr(g, f)
                self.rec[f] = None if v is None else np.asarray(v)
            return [{"loss": 1.0}]

        def evaluate(self, g, mask=None, n_classes=None, **kw):
            y = np.asarray(g.y)[np.asarray(g.test_mask if mask is None else mask)]
            return {"f1_macro": float(np.mean(y % 2)), "accuracy": float(np.mean(y % 3 == 0))}

    return Recorder


def _assert_same_calls(got, want):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.keys() == b.keys(), (i, a.keys() ^ b.keys())
        for k in a:
            if isinstance(b[k], np.ndarray) or isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k], err_msg=f"trainer {i}: {k}")
            else:
                assert a[k] == b[k], (i, k, a[k], b[k])


def _record(monkeypatch, module, model_names=("GCN", "EGCN")):
    calls = []
    monkeypatch.setattr(module, "Trainer", _trainer_recorder(calls))
    for name in model_names:
        monkeypatch.setattr(module, name, _model_recorder(name))
    return calls


@pytest.mark.parametrize("hierarchy,models", [
    ("flat", ("GCN", "EGCN")), ("per-level", ("GCN",)), ("per-label", ("GCN",))])
def test_hyperopt_feeds_its_trainers_what_jax_feeds_its_own(monkeypatch, tmp_path, hierarchy,
                                                            models):
    # every fold of every configuration: the labels (the per-label child
    # relabeling), the fold's masks over the document nodes, the parent
    # one-hot features, the widths, the trainer's settings; then the rows
    import hyperopt as jax_hyperopt

    argv = ["--hierarchy", hierarchy, "--epochs", "7", "--k-split", "3", "--lrs", "0.05",
            "0.01", "--dropouts", "0.5", "--max-dfs", "1.0", "0.9", "--models", *models,
            "--n-hidden", "16", "--seed", "3", "--hybrid-k", "64"]
    want_calls = _record(monkeypatch, jax_hyperopt)
    got_calls = _record(monkeypatch, hyperopt)
    want = jax_hyperopt.main(argv + ["--out", str(tmp_path / "jax.csv")])
    got = hyperopt.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.csv")])
    _assert_same_calls(got_calls, want_calls)
    assert len(want_calls) == len(want) * 3  # a trainer a fold
    assert got == want
    with open(tmp_path / "jax.csv") as f, open(tmp_path / "port.csv") as g:
        assert list(csv.reader(g)) == list(csv.reader(f))


@pytest.mark.parametrize("flags", [
    [], ["--hybrid-k", "512", "--hybrid-f32-mode", "split2"],
    ["--hybrid-k", "512", "--pallas-dtype", "bfloat16"]], ids=["csr", "split2", "bf16"])
def test_protocol_feeds_its_trainers_what_jax_feeds_its_own(monkeypatch, tmp_path, flags):
    # each seed's trainer: the graph, the seed's masks, the model's widths
    # and the protocol's knobs, the hybrid settings; the rows' categories
    import protocol_parity as jax_protocol

    assert protocol.PROTOCOLS == jax_protocol.PROTOCOLS
    want_calls = _record(monkeypatch, jax_protocol)
    got_calls = []
    monkeypatch.setattr(protocol, "Trainer", _trainer_recorder(got_calls))
    monkeypatch.setattr(protocol, "make_model", lambda cfg, i, o, gen: SimpleNamespace(
        spec=(cfg.model.upper(), i, o, cfg.n_hidden, cfg.dropout)))
    argv = ["--protocol", "amazon", "--n-docs", "600", "--epochs", "20", "--seeds", "42", "43",
            "--verbose", "0", "--plan-cache", "", *flags]
    jax_protocol.main(argv + ["--frameworks", "jax", "--out", str(tmp_path / "jax.csv")])
    protocol.main(argv + ["--device", "cpu", "--out", str(tmp_path / "port.csv")])
    for rec in got_calls:
        rec["optimizer"] = None  # the JAX driver names its default optimizer None
    _assert_same_calls(got_calls, want_calls)
    assert [c["shares"] for c in got_calls] == [False, True]  # one operator for the seeds
    with open(tmp_path / "jax.csv") as f, open(tmp_path / "port.csv") as g:
        want_rows, got_rows = list(csv.DictReader(f)), list(csv.DictReader(g))
    assert [r["category"].replace("jax", "torch-cpu") for r in want_rows] == [
        r["category"] for r in got_rows]
    for key in ("seed", "model", "hierarchy", "f1-macro", "accuracy", "dataset"):
        assert [r[key] for r in got_rows] == [r[key] for r in want_rows], key


@pytest.mark.parametrize("corpus", ["classes", "zipf"])
def test_benchmark_graph_edges_equal_jax(monkeypatch, corpus):
    import benchmark_graph as jax_bg

    graphs = {"jax": [], "port": []}

    def recording(module, key):
        real = module.Text2Graph

        class Rec(real):
            def fit_transform(self, *a, **kw):
                g = super().fit_transform(*a, **kw)
                graphs[key].append(g)
                return g

        monkeypatch.setattr(module, "Text2Graph", Rec)

    recording(jax_bg, "jax")
    recording(benchmark_graph, "port")
    argv = ["--n-docs", "300", "--corpus", corpus, "--v-draw", "3000"]
    jax_bg.main(argv + ["--backends", "native"])
    benchmark_graph.main(argv + ["--device", "cpu"])
    (want,), got = graphs["jax"], graphs["port"]
    assert len(got) == 2 and want.n_edges > 0
    for g in got:  # native and device counting
        assert (g.n_vocab, g.n_docs) == (want.n_vocab, want.n_docs)
        for f in ("edge_src", "edge_dst", "edge_w", "y", "test_mask"):
            np.testing.assert_array_equal(np.asarray(getattr(g, f)),
                                          np.asarray(getattr(want, f)), err_msg=f)


def _run(tmp_path, hierarchy, models=("GCN",)):
    out = str(tmp_path / f"ho_{hierarchy}.csv")
    rows = hyperopt.main([
        "--device", "cpu", "--hierarchy", hierarchy, "--epochs", "5", "--k-split", "2",
        "--lrs", "0.05", "--dropouts", "0.5", "--max-dfs", "1.0",
        "--models", *models, "--n-hidden", "16", "--out", out,
    ])
    with open(out) as f:
        assert list(csv.DictReader(f)) == [{k: str(v) for k, v in r.items()} for r in rows]
    return rows


def test_hyperopt_per_level(monkeypatch, tmp_path):
    dims = []
    real = hyperopt.Trainer.fit

    def fit(self, g, **kw):
        dims.append((g.in_dim, g.n_nodes, g.hierarchy_feats.shape))
        return real(self, g, **kw)

    monkeypatch.setattr(hyperopt.Trainer, "fit", fit)
    rows = _run(tmp_path, "per-level")
    assert len(rows) == 1
    assert set(rows[0]) == {"LR", "DO", "max_df", "model", "mean f1", "std f1"}
    assert np.isfinite(rows[0]["mean f1"])
    # the true parent's one-hot is appended to the features
    in_dim, n_nodes, feats = dims[0]
    assert feats[1] == 3 and in_dim == n_nodes + 3  # identity + 3 parents


def test_hyperopt_per_label(tmp_path):
    rows = _run(tmp_path, "per-label")
    # one row per parent classifier (the synthetic corpus has 3 parents)
    assert len(rows) == 3
    assert [r["2lc"] for r in rows] == [f"classifier_{i}" for i in range(3)]
    assert all(np.isfinite(r["mean f1"]) for r in rows)


def test_hyperopt_flat_grid_with_egcn(tmp_path):
    rows = _run(tmp_path, "flat", models=("GCN", "EGCN"))
    assert [r["model"] for r in rows] == ["GCN", "EGCN"]
    assert all(0.0 <= r["mean f1"] <= 1.0 for r in rows)


def test_hyperopt_cuda_error_propagates(monkeypatch, tmp_path):
    def fit(self, *a, **kw):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(hyperopt.Trainer, "fit", fit)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(tmp_path, "flat")


def test_hyperopt_diverged_config_is_a_nan_row(monkeypatch, tmp_path):
    monkeypatch.setattr(hyperopt.Trainer, "fit",
                        lambda self, *a, **kw: [{"loss": 1.0}, {"loss": float("nan")}])
    rows = _run(tmp_path, "flat")
    assert len(rows) == 1 and math.isnan(rows[0]["mean f1"]) and math.isnan(rows[0]["std f1"])


def test_hyperopt_floating_point_error_is_a_nan_row(monkeypatch, tmp_path):
    def fit(self, *a, **kw):
        raise FloatingPointError("debug_checks: loss holds inf at epoch 3")

    monkeypatch.setattr(hyperopt.Trainer, "fit", fit)
    rows = _run(tmp_path, "per-label")
    assert len(rows) == 3 and all(math.isnan(r["mean f1"]) for r in rows)


def test_benchmark_graph_backends_agree():
    out = benchmark_graph.main(["--device", "cpu", "--n-docs", "300", "--corpus", "zipf",
                                "--v-draw", "3000", "--plan-bench"])
    assert [r["backend"] for r in out["backends"]] == ["native", "device"]
    assert out["edges_equal"] and out["backends"][0]["n_edges"] > 0
    assert out["plan"]["cold_s"] > 0 and out["plan"]["warm_s"] > 0


def test_benchmark_graph_refuses_sharded():
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        benchmark_graph.main(["--device", "cpu", "--backends", "native", "sharded"])


def _protocol(tmp_path, *extra):
    out = str(tmp_path / "rows.csv")
    rows = protocol.main(["--device", "cpu", "--n-docs", "1000", "--epochs", "40",
                          "--seeds", "42", "--out", out, "--verbose", "0", *extra])
    with open(out) as f:
        return rows, list(csv.DictReader(f))[-1]


def test_protocol_split2_rows_match_the_csr_rows(tmp_path):
    base, base_row = _protocol(tmp_path)
    split, split_row = _protocol(tmp_path, "--hybrid-k", "512", "--hybrid-f32-mode", "split2")
    assert (base_row["category"], split_row["category"]) == ("torch-cpu", "torch-cpu-split2")
    assert base[0]["f1_macro"] > 0.1  # the model learned something
    assert abs(split[0]["f1_macro"] - base[0]["f1_macro"]) <= 1e-4
    assert abs(split[0]["final_loss"] - base[0]["final_loss"]) <= 1e-4


def test_protocol_category_and_flags():
    assert protocol.category("cuda", None, "split2", "float32") == "torch-cuda"
    assert protocol.category("cuda", 4096, "split2", "float32") == "torch-cuda-split2"
    assert protocol.category("cuda", 4096, "highest", "float32") == "torch-cuda"
    assert protocol.category("cuda", None, "highest", "bfloat16") == "torch-cuda-bf16"
    assert protocol.hybrid_k_flag("off") is None and protocol.hybrid_k_flag("auto") == "auto"
    assert protocol.hybrid_k_flag("4096") == 4096
    with pytest.raises(SystemExit):
        protocol.main(["--device", "cpu", "--model", "mlp", "--hybrid-k", "512"])
    with pytest.raises(SystemExit):
        protocol.main(["--device", "cpu", "--hybrid-k", "many"])


@pytest.mark.parametrize("env,want", [({"PYTEXTGCN_NO_MALLOPT": "1"}, "False"), ({}, "True")],
                         ids=["disabled", "applied"])
def test_tune_allocator_in_a_fresh_process(env, want):
    code = ("import pytextgcn_tpu_torch.utils as u, pytextgcn_tpu_torch as p; "
            "print(u._tuned, u.tune_allocator())")
    full = {k: v for k, v in os.environ.items() if k != "PYTEXTGCN_NO_MALLOPT"}
    full.update(env, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=full, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == [want, want]  # applied at import, the same answer after
