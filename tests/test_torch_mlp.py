"""The port's TF-IDF + MLP baseline (``models/mlp.py``,
``baselines/mlp_pipeline.py``, ``experiments/mlp.py``) against the JAX
package, from shared numpy inputs and parameters (device 'cpu': the CSR
kernel's plain version, and the plain gather path).

Tolerances: products and gradients 1e-5 relative to the largest magnitude
of the compared array (f32 sums in other orders); training histories 1e-4
on the losses at dropout 0 (torch's Adam and optax.adam round their bias
corrections differently, about 1e-6 relative a step, which Adam's
normalized steps carry on), the validation F1s (argmax counts) and the
stopping epoch equal; TF-IDF matrices and predictions equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from scipy import sparse as sp

from pytextgcn_tpu.baselines import mlp_pipeline as jax_pipeline
from pytextgcn_tpu.models.mlp import MLP as JaxMLP
from pytextgcn_tpu.models.mlp import SparseMatrix as JaxSparseMatrix
from pytextgcn_tpu_torch.baselines import mlp_pipeline as pipeline
from pytextgcn_tpu_torch.baselines import patience_stop
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.experiments import mlp as mlp_driver
from pytextgcn_tpu_torch.models import MLP, SparseMatrix, export_params, load_jax_params

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * max(np.abs(want).max(), 1e-30))


def _random_sparse(n_rows, n_cols, density, seed):
    m = sp.random(n_rows, n_cols, density=density, random_state=np.random.RandomState(seed),
                  format="csr", dtype=np.float64)
    m.data = m.data.astype(np.float32) + 0.1
    m.data = m.data.astype(np.float64)
    return m


@pytest.fixture(scope="module")
def splits():
    docs, child, parent = synthetic_corpus(n_docs=240, n_classes=6, n_parents=3, seed=5)
    rng = np.random.default_rng(0)
    n = len(docs)
    idx = rng.permutation(n)
    tr, va, te = idx[: int(0.6 * n)], idx[int(0.6 * n): int(0.8 * n)], idx[int(0.8 * n):]
    child, parent = np.asarray(child), np.asarray(parent)
    args = ([docs[i] for i in tr], [docs[i] for i in va], [docs[i] for i in te],
            [parent[tr], child[tr]], [parent[va], child[va]], [parent[te], child[te]])
    return pipeline.fit_tfidf_splits(*args), jax_pipeline.fit_tfidf_splits(*args)


# ---------------------------------------------------------------- products


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("shape", [(120, 300, 32), (300, 90, 7)])
def test_sparse_matmul_and_weight_gradient_match_jax(use_pallas, shape):
    """Forward ``S @ W`` and ``dW = S^T g`` against JAX's interpret-mode
    ``_spmm_pallas`` and its segment path."""
    b, d, h = shape
    m = _random_sparse(b, d, 0.03, seed=b)
    m = m.tolil()
    m[3] = 0  # an empty document row
    m = m.tocsr()
    m.eliminate_zeros()
    rng = np.random.default_rng(1)
    w = rng.standard_normal((d, h)).astype(np.float32)
    ct = rng.standard_normal((b, h)).astype(np.float32)
    xs = SparseMatrix.from_scipy(m, use_pallas=use_pallas, device=CPU)
    assert (xs.plan is not None) == use_pallas
    wt = torch.tensor(w, requires_grad=True)
    out = xs.matmul(wt)
    (out * torch.tensor(ct)).sum().backward()
    for jax_pallas in (True, False):
        jxs = JaxSparseMatrix.from_scipy(m, use_pallas=jax_pallas)
        jout = jxs.matmul(jnp.asarray(w))
        jgrad = jax.grad(lambda v: jnp.sum(jxs.matmul(v) * ct))(jnp.asarray(w))
        _close(out.detach().numpy(), jout)
        _close(wt.grad.numpy(), jgrad)
    assert not out[3].any()


def test_sparse_matrix_slice_rows_keeps_the_path():
    m = _random_sparse(50, 40, 0.1, seed=3)
    xs = SparseMatrix.from_scipy(m, use_pallas=True, device=CPU)
    idx = np.array([4, 0, 17, 17])
    sub = xs.slice_rows(idx)
    assert sub.plan is not None and sub.shape == (4, 40)
    w = torch.randn(40, 5)
    _close(sub.matmul(w).numpy(), m[idx].toarray().astype(np.float32) @ w.numpy())


def test_entry_points_want_the_card_unless_told():
    m = _random_sparse(5, 4, 0.5, seed=0)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SparseMatrix.from_scipy(m)


# ------------------------------------------------------------------- model


@pytest.mark.parametrize("sparse_input", [True, False])
def test_mlp_logits_and_gradients_match_jax(sparse_input):
    rng = np.random.default_rng(2)
    m = _random_sparse(64, 80, 0.05, seed=9)
    jmodel = JaxMLP(80, 5, [16, 12], dropout=0.0)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(3)))
    model = load_jax_params(MLP(80, 5, [16, 12], dropout=0.0), params)
    exported = export_params(model)
    for a, b in zip(jax.tree.leaves(exported), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    y = rng.integers(0, 5, 64)
    if sparse_input:
        x, jx = SparseMatrix.from_scipy(m, use_pallas=True, device=CPU), \
            JaxSparseMatrix.from_scipy(m, use_pallas=True)
    else:
        dense = m.toarray().astype(np.float32)
        x, jx = torch.tensor(dense), jnp.asarray(dense)

    def jloss(p):
        logits = jmodel.apply(p, jx)
        return -jnp.mean(jnp.take_along_axis(jax.nn.log_softmax(logits), y[:, None], 1))

    logits = model(x)
    loss = torch.nn.functional.cross_entropy(logits, torch.as_tensor(y))
    loss.backward()
    _close(logits.detach().numpy(), jmodel.apply(jax.tree.map(jnp.asarray, params), jx))
    jgrads = jax.grad(jloss)(jax.tree.map(jnp.asarray, params))
    for layer, jl in zip(model.layers, jgrads["layers"]):
        _close(layer.w.grad.numpy(), jl["w"])
        _close(layer.b.grad.numpy(), jl["b"])


def test_mlp_dropout_after_each_selu():
    model = MLP(6, 3, [8, 8], dropout=0.5, generator=torch.Generator().manual_seed(0))
    x = torch.randn(20, 6)
    a = model(x, train=True, generator=torch.Generator().manual_seed(1))
    b = model(x, train=True, generator=torch.Generator().manual_seed(1))
    c = model(x, train=True, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(model(x), model(x, train=False))


# ---------------------------------------------------------------- training


@pytest.mark.parametrize("use_pallas", [True, False])
def test_train_mlp_history_and_stop_match_jax(splits, use_pallas, monkeypatch):
    """Dropout 0, JAX's own initial parameters: the same loss and F1 history
    and the same stopping epoch (patience 4 after epoch 8, within 40)."""
    ours, theirs = splits
    seed, kw = 7, dict(hidden=(16,), lr=2e-2, dropout=0.0, epochs=40, patience=4,
                       min_epochs=8)
    n_classes = int(theirs.y_train[1].max()) + 1
    jmodel, jparams, jhist = jax_pipeline.train_mlp(
        theirs.x_train, theirs.y_train[1], theirs.x_val, theirs.y_val[1], n_classes,
        seed=seed, use_pallas=use_pallas, **kw)
    # train_mlp's own init: split(PRNGKey(seed)) -> (base, init)
    init = jax.tree.map(np.asarray, jmodel.init(jax.random.split(jax.random.PRNGKey(seed))[1]))

    class JaxInitMLP(MLP):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            load_jax_params(self, init)

    monkeypatch.setattr(pipeline, "MLP", JaxInitMLP)
    model, hist = pipeline.train_mlp(
        ours.x_train, ours.y_train[1], ours.x_val, ours.y_val[1], n_classes, seed=seed,
        use_pallas=use_pallas, device=CPU, **kw)
    assert 8 < len(jhist) < 40, "the run must stop early for the test to bite"
    assert len(hist) == len(jhist)
    np.testing.assert_allclose([l for l, _ in hist], [l for l, _ in jhist], rtol=1e-4)
    assert [f for _, f in hist] == [np.float32(f) for _, f in jhist]
    for a, b in zip(jax.tree.leaves(export_params(model)), jax.tree.leaves(jparams)):
        _close(a, b, rtol=1e-4)


def _jax_patience_rule(history, patience, min_epochs):
    """mlp_pipeline.py:287-295 (the JAX package's python loop), transcribed:
    the epoch at which it breaks, or None."""
    seen = []
    for epoch, f1 in enumerate(history):
        seen.append((0.0, f1))
        if epoch > min_epochs and epoch >= patience:
            dec = sum(seen[-(i + 1)][1] <= seen[-(patience + 1)][1] for i in range(patience))
            if dec >= patience:
                return epoch
    return None


@settings(max_examples=150, deadline=None)
@given(st.lists(st.sampled_from([0.1, 0.2, 0.25, 0.3, 0.5]), min_size=0, max_size=60),
       st.integers(1, 12), st.integers(0, 20))
def test_patience_rule_matches_the_jax_loop(f1s, patience, min_epochs):
    stop = next((e for e in range(len(f1s))
                 if patience_stop(f1s[:e + 1], patience, min_epochs)), None)
    assert stop == _jax_patience_rule(f1s, patience, min_epochs)


# ---------------------------------------------------------------- features


def test_tfidf_splits_are_bit_equal_to_jax(splits):
    ours, theirs = splits
    for a, b in ((ours.x_train, theirs.x_train), (ours.x_val, theirs.x_val),
                 (ours.x_test, theirs.x_test)):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert (a != b).nnz == 0
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    for a, b in zip(ours.y_train + ours.y_val + ours.y_test,
                    theirs.y_train + theirs.y_val + theirs.y_test):
        np.testing.assert_array_equal(a, b)


def test_append_onehot_feats_is_bit_equal_to_jax(splits):
    ours, _ = splits
    labels = ours.y_train[0]
    a = pipeline.append_onehot_feats(ours.x_train, labels, 4)
    b = jax_pipeline.append_onehot_feats(ours.x_train, labels, 4)
    assert a.shape == b.shape == (ours.x_train.shape[0], ours.x_train.shape[1] + 4)
    assert (a != b).nnz == 0 and a.dtype == b.dtype


# -------------------------------------------------- hierarchies and routing


def _shape_params(d_in, d_out, hidden):
    """Initial parameters drawn from the shapes alone, so both packages'
    pipelines start every model they train from the same numbers."""
    rng = np.random.default_rng(d_in * 1000 + d_out)
    dims = [d_in] + list(hidden) + [d_out]
    return {"layers": [{"w": (rng.standard_normal((a, b)) / np.sqrt(a)).astype(np.float32),
                        "b": (0.1 * rng.standard_normal(b)).astype(np.float32)}
                       for a, b in zip(dims[:-1], dims[1:])]}


@pytest.fixture
def shared_inits(monkeypatch):
    class PortMLP(MLP):
        def __init__(self, in_dim, out_dim, hidden, dropout=0.5, generator=None):
            super().__init__(in_dim, out_dim, hidden, dropout, generator)
            load_jax_params(self, _shape_params(in_dim, out_dim, hidden))

    class JaxShapeMLP(JaxMLP):
        def init(self, key):
            return jax.tree.map(jnp.asarray, _shape_params(self.in_dim, self.out_dim,
                                                           self.hidden))

    monkeypatch.setattr(pipeline, "MLP", PortMLP)
    monkeypatch.setattr(jax_pipeline, "MLP", JaxShapeMLP)


@pytest.mark.parametrize("hierarchy", ["per_level", "per_label"])
def test_hierarchies_route_by_predicted_labels_as_jax(splits, shared_inits, hierarchy):
    """Every model of the cascade / ensemble from the same parameters,
    dropout 0: the same level-0 predictions, then the same final predictions;
    the test documents go by the *predicted* parent (one-hot for per-level,
    the member for per-label), which differs from the true one here."""
    ours, theirs = splits
    kw = dict(hidden=(12,), lr=2e-3, dropout=0.0, epochs=3, early_stopping=False)
    run, jrun = getattr(pipeline, f"mlp_{hierarchy}"), getattr(jax_pipeline, f"mlp_{hierarchy}")
    res = run(ours, device=CPU, **kw)
    jres = jrun(theirs, **kw)
    parent_pred = res[0]["pred"]
    assert (parent_pred != ours.y_test[0]).any(), "routing by truth would pass as well"
    for r, j in zip(res, jres):
        np.testing.assert_array_equal(r["pred"], j["pred"])
        assert r["accuracy"] == pytest.approx(j["accuracy"], abs=1e-6)
        assert r["f1_macro"] == pytest.approx(j["f1_macro"], abs=1e-6)
    if hierarchy == "per_label":
        # each test document's child class belongs to its predicted parent
        child_parent = {int(c): int(p) for c, p in zip(ours.y_train[1], ours.y_train[0])}
        assert all(child_parent[int(c)] == int(p) for c, p in zip(res[1]["pred"], parent_pred))


def test_mesh_is_refused_with_a_pointer_to_the_roadmap(splits):
    """``mesh=`` runs the data-parallel step now (its ranks:
    tests/test_torch_multihost.py): a mesh of one rank gives the
    single-process history; what is not a ``parallel.Mesh`` is refused."""
    from pytextgcn_tpu_torch.parallel import Mesh

    ours, _ = splits
    args = (ours.x_train, ours.y_train[0], ours.x_val, ours.y_val[0], 3)
    kw = dict(hidden=(16,), epochs=6, dropout=0.5, early_stopping=False)
    one_rank = Mesh(None, 0, 1, torch.device(CPU))
    _, hist = pipeline.train_mlp(*args, device=CPU, **kw)
    _, hist_dp = pipeline.train_mlp(*args, mesh=one_rank, **kw)
    np.testing.assert_allclose(hist_dp, hist, rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError, match="parallel.Mesh"):
        pipeline.train_mlp(*args, epochs=1, device=CPU, mesh=object())
    with pytest.raises(ValueError, match="is not the mesh's"):
        pipeline.train_mlp(*args, epochs=1, device="cuda", mesh=one_rank)


# ------------------------------------------------------------------ driver


@pytest.mark.parametrize("hierarchy", ["flat", "per-level", "per-label"])
def test_mlp_driver_writes_a_row_per_level(tmp_path, hierarchy):
    out = tmp_path / "rows.csv"
    res = mlp_driver.main(["--device", "cpu", "--hierarchy", hierarchy, "--train-epochs", "8",
                           "--train-verbose", "0", "--result-file", str(out)])
    assert len(res) == 2 and all(0.0 <= r["accuracy"] <= 1.0 for r in res)
    lines = out.read_text().splitlines()
    assert lines[0] == "seed,model,hierarchy,dataset,category,f1-macro,accuracy"
    assert lines[1].startswith(f"44,MLP,{hierarchy},synthetic,0,")
    assert lines[2].startswith(f"44,MLP,{hierarchy},synthetic,1,")


def test_mlp_driver_defaults_and_flags():
    cfg = mlp_driver.parse_config(["--train-lr", "0.01"])
    kw = mlp_driver.train_kwargs(cfg, {"--train-lr"})
    assert kw["lr"] == 0.01 and kw["dropout"] == 0.5 and kw["use_pallas"]
    kw = mlp_driver.train_kwargs(mlp_driver.parse_config([]), set())
    assert kw["lr"] == 2e-3 and kw["hidden"] == (256, 128)


def test_protocol_mlp_splits_match_mlp_parity_and_write_rows(tmp_path):
    """``protocol.py --model mlp`` draws experiments/mlp_parity.py's split
    (bit-equal TF-IDF matrices and labels) and writes one row a seed."""
    import os
    import sys

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))
    from mlp_parity import build_splits as jax_build_splits

    from pytextgcn_tpu_torch.data.synthetic import protocol_corpus
    from pytextgcn_tpu_torch.experiments import protocol

    for name in ("amazon", "dbpedia"):
        ours = protocol.mlp_splits(protocol_corpus(name, n_docs=1200), seed=43)
        theirs = jax_build_splits(name, 1200, seed=43)
        for a, b in ((ours.x_train, theirs.x_train), (ours.x_val, theirs.x_val),
                     (ours.x_test, theirs.x_test)):
            assert a.shape == b.shape and (a != b).nnz == 0
        for a, b in zip(ours.y_train + ours.y_test, theirs.y_train + theirs.y_test):
            np.testing.assert_array_equal(a, b)
    out = tmp_path / "rows.csv"
    rows = protocol.main(["--device", "cpu", "--model", "mlp", "--n-docs", "1200",
                          "--epochs", "5", "--seeds", "42", "43", "--out", str(out),
                          "--verbose", "0"])
    assert [r["epochs_ran"] for r in rows] == [5, 5]
    lines = out.read_text().splitlines()
    assert len(lines) == 3 and lines[1].startswith("42,MLP,flat,synthetic-amazon,torch-cpu,")
