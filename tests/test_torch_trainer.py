"""The port's flat slice end to end against the JAX package: corpus ->
Text2Graph -> Trainer.fit -> evaluate, with shared initial parameters and
dropout 0, plus the flat experiment's command line."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu import Text2Graph as JaxText2Graph
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch import utils
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.experiments import flat
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops.hybrid import HybridPlan
from pytextgcn_tpu_torch.ops.spmm_cuda import SpmmPlan
from pytextgcn_tpu_torch.train import Trainer


@pytest.fixture(scope="module")
def graphs():
    docs, labels = synthetic_corpus(n_docs=200, n_classes=4, seed=7)
    rng = np.random.default_rng(0)
    test_idx = rng.choice(200, 40, replace=False)
    val_idx = np.setdiff1d(rng.choice(200, 30, replace=False), test_idx)
    kw = dict(min_df=1, window_size=5)
    g = Text2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx, val_idx=val_idx)
    jg = JaxText2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx, val_idx=val_idx)
    return g, jg


@pytest.mark.parametrize(
    "es", [dict(early_stopping="reference"),
           dict(early_stopping="val_f1", patience=2, min_epochs=3)],
    ids=["reference", "val_f1"])
def test_fit_trajectory_matches_jax_trainer(graphs, es):
    g, jg = graphs
    model = GCN(g.in_dim, 4, n_hidden_gcn=16, dropout=0.0,
                generator=torch.Generator().manual_seed(1))
    params = export_params(model)

    jtrainer = JaxTrainer(JaxGCN(jg.in_dim, 4, n_hidden_gcn=16, dropout=0.0), lr=0.05)
    jtrainer.params = jax.tree.map(jnp.asarray, params)
    jhist = jtrainer.fit(jg, epochs=10, n_classes=4, **es)
    jmetrics = jtrainer.evaluate(jg, n_classes=4)

    trainer = Trainer(model, lr=0.05, device="cpu")  # kernel plan -> plain version
    hist = trainer.fit(g, epochs=10, n_classes=4, **es)
    metrics = trainer.evaluate(g, n_classes=4)

    # the same stop epoch: the reference rule does not fire in 10 epochs of
    # this run, the val-F1 patience rule does
    assert len(hist) == len(jhist)
    assert (len(hist) < 10) == (es["early_stopping"] == "val_f1")
    np.testing.assert_allclose([r["loss"] for r in hist], [r["loss"] for r in jhist],
                               rtol=1e-4)
    for key in ("val_loss", "val_f1", "train_acc"):
        np.testing.assert_allclose([r[key] for r in hist], [r[key] for r in jhist],
                                   rtol=1e-4, atol=1e-6)
    assert metrics == pytest.approx(jmetrics, rel=1e-6)


def test_flat_experiment_writes_results_row(tmp_path):
    out = tmp_path / "results.csv"
    res = flat.main(["--device", "cpu", "--train-epochs", "15", "--train-verbose", "0",
                     "--result-file", str(out)])
    losses = [rec["loss"] for rec in res["history"]]
    assert len(losses) == 15 and np.isfinite(losses).all()
    assert res["accuracy"] > 0.5
    lines = out.read_text().splitlines()
    assert lines[0] == "seed,model,hierarchy,f1-macro,accuracy"
    assert lines[1].startswith("44,GCN,flat,")


@pytest.mark.parametrize("flag", [
    ["--train-sharding", "hybrid", "--train-n-devices", "2", "--train-plan-cache", "plans"],
    ["--train-sharding", "halo", "--train-hybrid-k", "128", "--train-n-devices", "2"],
    ["--train-sharding", "allgather", "--train-n-devices", "2", "--train-batch-size", "8"],
    ["--train-batch-size", "8", "--train-masked-head", "true"],
])
def test_flat_experiment_refuses_unported_settings(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        flat.main(["--device", "cpu", *flag])


@pytest.mark.parametrize("flag", [["--graph-backend", "sharded"],
                                  ["--train-ep", "true", "--train-n-devices", "2"]],
                         ids=["sharded-counting", "ep-over-ranks"])
def test_flat_experiment_takes_what_item_4c_refused(flag, tmp_path):
    """The flat experiment runs with what ROADMAP.md §1 item 4c refused:
    sharded counting gives the native build's row; the ensemble's flags
    belong to the per-label driver, so the flat run starts no ranks and
    writes the row it writes without them."""
    rows = []
    for extra in ([], flag):
        path = tmp_path / f"{len(rows)}.csv"
        res = flat.main(["--device", "cpu", "--train-epochs", "3", "--train-verbose", "0",
                         "--result-file", str(path), *extra])
        assert res is not None  # this process ran it
        rows.append(path.read_text().strip().splitlines())
    assert rows[0] == rows[1]


def test_entry_points_raise_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        utils.resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(GCN(10, 2, n_hidden_gcn=4))
    assert utils.resolve_device("cpu") == torch.device("cpu")


def test_dropout_stream_is_not_the_parameter_stream():
    """The drivers draw a model's parameters from
    ``torch.Generator().manual_seed(seed)`` and its trainer takes the same
    seed: the dropout masks must not replay the initial weights' uniforms
    (on the CPU a generator seeded with the same integer would: the first
    mask kept exactly W1's lowest 30%)."""
    seed, rate = 42, 0.7
    model = GCN(500, 6, n_hidden_gcn=100, dropout=rate,
                generator=torch.Generator().manual_seed(seed))
    trainer = Trainer(model, seed=seed, device="cpu")
    w = model.layers[0].w.detach()
    limit = (6.0 / (500 + 100)) ** 0.5
    lowest = (w + limit) / (2 * limit) < 1 - rate  # the init's uniforms below 0.3
    mask = torch.rand(w.shape, generator=trainer.generator) < 1 - rate
    agree = float((mask == lowest).float().mean())
    # independent streams agree on 0.3^2 + 0.7^2 = 58% of the entries, one stream on all
    assert abs(agree - 0.58) < 0.01, agree



@pytest.mark.parametrize("path", [dict(), dict(masked_head=True), dict(hybrid_k=16)])
def test_debug_checks_catches_nan(graphs, path):
    """Mirrors tests/test_resume_and_misc.py::test_debug_checks_catches_nan:
    a clean graph trains; a NaN edge weight raises at the first epoch, naming
    the tensor. Debug mode keeps the trainer's path: the kernel's (its plain
    version on the CPU), the masked head's or the hybrid's."""
    import dataclasses

    g, jg = graphs
    n_classes = 4
    make = lambda: GCN(g.in_dim, n_classes, n_hidden_gcn=8, dropout=0.0,
                       generator=torch.Generator().manual_seed(0))
    t = Trainer(make(), lr=0.05, seed=0, device="cpu", debug_checks=True, **path)
    assert t.aggregation.use_pallas and (t.masked_head, t.aggregation.hybrid_k) == (
        path.get("masked_head", False), path.get("hybrid_k"))
    hist = t.fit(g, epochs=3, n_classes=n_classes)  # clean graph: no error
    assert len(hist) == 3
    assert isinstance(t._adj.plan, HybridPlan if "hybrid_k" in path else SpmmPlan)
    assert (t._adj_out is not None) == ("masked_head" in path)

    bad_w = np.asarray(g.edge_w).copy()
    bad_w[0] = np.nan
    g_bad = dataclasses.replace(g, edge_w=bad_w)
    t2 = Trainer(make(), lr=0.05, seed=0, device="cpu", debug_checks=True, **path)
    with pytest.raises(FloatingPointError, match=r"(?i)nan.*epoch 1"):
        t2.fit(g_bad, epochs=3, n_classes=n_classes)
    # the JAX trainer's checkify mode raises on the same graph
    jbad = dataclasses.replace(jg, edge_w=bad_w)
    jt = JaxTrainer(JaxGCN(jg.in_dim, n_classes, n_hidden_gcn=8, dropout=0.0), lr=0.05,
                    seed=0, debug_checks=True)
    with pytest.raises(Exception, match="(?i)nan"):
        jt.fit(jbad, epochs=3, n_classes=n_classes)


def test_debug_checks_names_an_inf_gradient(graphs):
    g, _ = graphs
    model = GCN(g.in_dim, 4, n_hidden_gcn=8, dropout=0.0,
                generator=torch.Generator().manual_seed(0))
    model.layers[1].b.register_hook(lambda grad: grad * float("inf"))
    t = Trainer(model, lr=0.05, device="cpu", debug_checks=True)
    with pytest.raises(FloatingPointError, match=r"gradient of layers\.1\.b holds inf"):
        t.fit(g, epochs=2, n_classes=4)


def test_flat_experiment_runs_debug_checks_and_optax_amsgrad():
    for flag in (["--train-debug-checks", "true"], ["--train-optimizer", "optax_amsgrad"]):
        res = flat.main(["--device", "cpu", "--train-epochs", "6", "--train-verbose", "0",
                         *flag])
        losses = [r["loss"] for r in res["history"]]
        assert len(losses) == 6 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert type(res["trainer"].optimizer).__name__ == "OptaxAmsgrad"


@pytest.mark.parametrize("driver", ["flat", "perlevel", "perlabel"])
def test_graph_drivers_refuse_the_mlp(driver):
    import importlib

    main = importlib.import_module(f"pytextgcn_tpu_torch.experiments.{driver}").main
    with pytest.raises(SystemExit, match="experiments/mlp.py"):
        main(["--device", "cpu", "--model-model", "mlp"])
