"""The port's per-level cascade and per-label ensemble against the JAX
package's, and the hierarchy drivers end to end on the CPU.

Both packages build the same graph (the port's Text2Graph is bitwise the
JAX one) and get the same numpy parameters for every level and member,
drawn in the order the factories are called, at dropout 0 (dropout streams
cannot match across frameworks). Both train with plain Adam. Metrics must
agree within 1e-6 and the test predictions be identical; per-epoch losses
within 1e-4 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu import Text2Graph as JaxText2Graph
from pytextgcn_tpu.hierarchy import eval_per_label as jax_eval_per_label
from pytextgcn_tpu.hierarchy import perlevel as jax_perlevel
from pytextgcn_tpu.hierarchy import train_per_label as jax_train_per_label
from pytextgcn_tpu.hierarchy import train_per_level as jax_train_per_level
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.experiments import perlabel, perlevel, protocol
from pytextgcn_tpu_torch.hierarchy import eval_per_label, train_per_label, train_per_level
from pytextgcn_tpu_torch.hierarchy import perlevel as port_perlevel
from pytextgcn_tpu_torch.models import GCN, export_params, load_jax_params

HIDDEN, EPOCHS = 12, 12


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on one machine; torch's default
    of one intra-op thread per core in each of them oversubscribes the
    cores and slows these small CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    docs, child, parent = synthetic_corpus(n_docs=160, n_classes=6, n_parents=3, seed=11)
    child, parent = np.asarray(child), np.asarray(parent)
    rng = np.random.default_rng(1)
    test_idx = rng.choice(len(docs), len(docs) // 4, replace=False)
    kw = dict(min_df=1, window_size=5)
    g = Text2Graph(**kw).fit_transform(docs, child, test_idx=test_idx)
    jg = JaxText2Graph(**kw).fit_transform(docs, child, test_idx=test_idx)
    np.testing.assert_array_equal(g.edge_w, jg.edge_w)
    return g, jg, child, parent


class _Factories:
    """Model factories for both packages that hand out the same numpy
    parameters: the k-th call of either gets the k-th draw."""

    def __init__(self):
        self.jax_calls = self.port_calls = 0

    @staticmethod
    def _params(k, in_dim, out_dim):
        rng = np.random.default_rng(100 + k)
        dims = [in_dim, HIDDEN, out_dim]
        return {"layers": [{"w": (rng.standard_normal((a, b)) * 0.3).astype(np.float32),
                            "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
                           for a, b in zip(dims[:-1], dims[1:])]}

    def jax(self, in_dim, out_dim):
        params = self._params(self.jax_calls, in_dim, out_dim)
        self.jax_calls += 1
        model = JaxGCN(in_dim, out_dim, n_hidden_gcn=HIDDEN, dropout=0.0)
        model.init = lambda key: jax.tree.map(jnp.asarray, params)
        return model

    def port(self, in_dim, out_dim):
        params = self._params(self.port_calls, in_dim, out_dim)
        self.port_calls += 1
        return load_jax_params(GCN(in_dim, out_dim, n_hidden_gcn=HIDDEN, dropout=0.0), params)


def _final_level_preds(pkg, res, g, levels):
    """The last level's test predictions on its evaluation graph (fed the
    softmax of the level before, computed on that level's own graph)."""
    trainers = res["trainers"]
    one_hot = pkg.one_hot_np
    prev_gt = one_hot(levels[-3]) if len(levels) >= 3 else None
    g_prev = pkg._with_labels_and_feats(g, levels[-2], prev_gt)
    logits = np.asarray(trainers[-2].predict_logits(g_prev))[g.n_vocab:]
    soft = np.exp(logits - logits.max(-1, keepdims=True))
    soft /= soft.sum(-1, keepdims=True)
    g_eval = pkg._with_labels_and_feats(g, levels[-1], soft)
    pred = np.asarray(trainers[-1].predict_logits(g_eval)).argmax(-1)
    return pred[np.asarray(g.test_mask)]


def _assert_histories_close(hists, jhists):
    assert len(hists) == len(jhists)
    for h, jh in zip(hists, jhists):
        assert len(h) == len(jh) == EPOCHS
        np.testing.assert_allclose([r["loss"] for r in h], [r["loss"] for r in jh], rtol=1e-4)


@pytest.mark.parametrize("n_levels", [2, 3])
def test_per_level_cascade_matches_jax(corpus, n_levels):
    g, jg, child, parent = corpus
    levels = [parent, child] if n_levels == 2 else [parent % 2, parent, child]
    f = _Factories()
    jres = jax_train_per_level(jg, levels, f.jax, epochs=EPOCHS, seed=5)
    res = train_per_level(g, levels, f.port, epochs=EPOCHS, seed=5,
                          trainer_kwargs={"device": "cpu"})
    assert res["metrics"] == pytest.approx(jres["metrics"], rel=1e-6, abs=1e-7)
    _assert_histories_close(res["histories"], jres["histories"])
    # levels past the first carry the previous level's width, on one operator
    assert res["trainers"][-1]._feats.hierarchy.shape[1] == int(levels[-2].max()) + 1
    assert all(t._adj is res["trainers"][0]._adj for t in res["trainers"])
    with torch.no_grad():
        got = _final_level_preds(port_perlevel, res, g, levels)
    want = _final_level_preds(jax_perlevel, jres, jg, levels)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ["ground_truth", "predicted"])
def test_per_label_ensemble_matches_jax(corpus, route, tmp_path):
    g, jg, child, parent = corpus
    f = _Factories()
    jens = jax_train_per_label(jg, child, parent, f.jax, epochs=EPOCHS, seed=5,
                               save_dir=str(tmp_path / "jax"))
    ens = train_per_label(g, child, parent, f.port, epochs=EPOCHS, seed=5,
                          save_dir=str(tmp_path / "port"), trainer_kwargs={"device": "cpu"})
    assert ens["mapping"] == jens["mapping"]
    assert all(t._adj is ens["trainers"][0]._adj for t in ens["trainers"])
    parent_pred = None
    if route == "predicted":  # a router that is wrong on a third of the documents
        rng = np.random.default_rng(3)
        parent_pred = np.where(rng.random(len(parent)) < 0.33,
                               rng.integers(0, 3, len(parent)), parent)
    jm = jax_eval_per_label(jg, child, parent, jens["trainers"], jens["mapping"],
                            parent_pred=parent_pred, route=route)
    m = eval_per_label(g, child, parent, ens["trainers"], ens["mapping"],
                       parent_pred=parent_pred, route=route)
    np.testing.assert_array_equal(m["predictions"], jm["predictions"])
    assert (m["predictions"][np.asarray(g.test_mask)[g.n_vocab:]] >= 0).all()
    assert m["accuracy"] == pytest.approx(jm["accuracy"], rel=1e-6)
    assert m["f1_macro"] == pytest.approx(jm["f1_macro"], rel=1e-6)
    # the files: the same class mapping, and members that the JAX package
    # loads into its own parameter trees as the port's parameters
    assert (json.loads((tmp_path / "port" / "class_mapping.json").read_text())
            == json.loads((tmp_path / "jax" / "class_mapping.json").read_text()))
    for c, (trainer, jtrainer) in enumerate(zip(ens["trainers"], jens["trainers"])):
        path = str(tmp_path / "port" / f"lvl2-cat{c}")
        params, _ = jax_load_checkpoint(path, jtrainer.params)
        mine = export_params(trainer.model)
        assert jax.tree.structure(params) == jax.tree.structure(mine)
        for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(mine)):
            np.testing.assert_array_equal(np.asarray(a), b)


def test_unrouted_documents_score_as_wrong(corpus):
    """A parent no member takes leaves its documents at -1, scored as a
    label of their own (n_classes = max + 2)."""
    g, _, child, parent = corpus
    f = _Factories()
    ens = train_per_label(g, child, parent, f.port, epochs=2, trainer_kwargs={"device": "cpu"})
    routed_nowhere = np.full(len(parent), 7)
    m = eval_per_label(g, child, parent, ens["trainers"], ens["mapping"],
                       parent_pred=routed_nowhere, route="predicted")
    assert (m["predictions"] == -1).all() and m["accuracy"] == 0.0 and m["f1_macro"] == 0.0
    with pytest.raises(ValueError, match="parallel.Mesh"):  # neither a Mesh nor a count
        train_per_label(g, child, parent, f.port, mesh=object())
    with pytest.raises(ValueError, match="parent_pred"):
        eval_per_label(g, child, parent, ens["trainers"], ens["mapping"], route="predicted")


def test_perlevel_driver_on_cpu(tmp_path):
    out = tmp_path / "rows.csv"
    res = perlevel.main(["--device", "cpu", "--train-epochs", "15", "--train-verbose", "0",
                         "--result-file", str(out)])
    assert len(res["trainers"]) == 2 and res["accuracy"] > 0.5
    assert all(np.isfinite([r["loss"] for r in h]).all() for h in res["histories"])
    assert out.read_text().splitlines()[1].startswith("44,GCN,per-level,")


@pytest.mark.parametrize("route", ["ground_truth", "predicted"])
def test_perlabel_driver_save_and_eval_only(tmp_path, route):
    out, models = tmp_path / "rows.csv", tmp_path / "models"
    argv = ["--device", "cpu", "--train-epochs", "10", "--train-verbose", "0",
            "--result-file", str(out), "--save-model", str(models), "--route", route]
    trained = perlabel.main(argv)
    loaded = perlabel.main(argv + ["--eval-only"])
    assert all(t._adj is loaded["trainers"][0]._adj for t in loaded["trainers"])
    np.testing.assert_array_equal(trained["predictions"], loaded["predictions"])
    assert trained["accuracy"] == loaded["accuracy"] > 0.5
    assert len(loaded["trainers"]) == 3 and (models / "lvl2-cat2.npz").exists()
    rows = out.read_text().splitlines()
    assert len(rows) == 3 and rows[2].startswith("44,GCN,per-label,")


def test_protocol_driver_on_cpu(tmp_path):
    out = tmp_path / "rows.csv"
    rows = protocol.main(["--device", "cpu", "--protocol", "dbpedia", "--hierarchy",
                          "perlevel", "--n-docs", "1500", "--epochs", "3", "--seeds", "42", "43",
                          "--out", str(out), "--verbose", "0"])
    assert [r["seed"] for r in rows] == [42, 43]
    lines = out.read_text().splitlines()
    assert lines[0] == "seed,model,hierarchy,dataset,category,f1-macro,accuracy"
    # a run on the CPU is labelled so, not as a card's
    assert lines[1].startswith("42,GCN,per-level,synthetic-dbpedia,torch-cpu,")


@pytest.mark.parametrize("driver", [perlevel, perlabel, protocol])
def test_drivers_raise_without_gpu(monkeypatch, driver):
    """Without ``--device cpu`` the drivers run on the card, and raise when
    there is none instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = (["--n-docs", "1500", "--epochs", "1"] if driver is protocol
            else ["--train-epochs", "1", "--train-verbose", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        driver.main(argv)
