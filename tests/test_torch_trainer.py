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
    ["--train-debug-checks", "true"], ["--train-sharding", "allgather"],
    ["--train-sharding", "halo"], ["--model-model", "mlp"], ["--dataset", "amazon"],
    ["--train-batch-size", "64"],
])
def test_flat_experiment_refuses_unported_settings(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        flat.main(["--device", "cpu", *flag])


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

