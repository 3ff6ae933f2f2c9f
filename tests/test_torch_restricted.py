"""The port's masked head (ops/restricted.py, ``Trainer(masked_head=True)``)
against the JAX package's, on the CPU (device 'cpu': the CSR kernel's plain
version; JAX runs its Pallas kernel in interpret mode).

Tolerances: the restricted operator and its VJP at rtol 1e-4, atol 1e-5, the
band of tests/test_restricted.py:42-82; a masked-head fit against a
full-output fit at rtol 1e-5, atol 1e-6, the band of
tests/test_restricted.py:85-103 (masked CE over M rows and over N rows with
a mask can differ in the last bit); the CSR body's rows bit for bit equal
to the full product's on the CPU (both sum each row's edges in the same
order: the stable destination sort keeps it).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.ops.restricted import build_restricted_adj as jax_build_restricted
from pytextgcn_tpu.ops.restricted import spmm_restricted as jax_spmm_restricted
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.models import EGCN, GCN, JumpingKnowledgeNetwork, export_params
from pytextgcn_tpu_torch.ops import NormAdj
from pytextgcn_tpu_torch.ops.restricted import build_restricted_adj, spmm_restricted
from pytextgcn_tpu_torch.ops.spmm import spmm
from pytextgcn_tpu_torch.train import Trainer

MODES = {"segment": dict(), "csr": dict(use_pallas=True), "hybrid64": dict(hot_k=64),
         "hybrid-auto": dict(hot_k="auto", use_pallas=True)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(seed, n_vocab=70, n_docs=90, n_edges=3000):
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    zeros = np.zeros(n, bool)
    tm, vm, sm = zeros.copy(), zeros.copy(), zeros.copy()
    tm[n_vocab:n_vocab + 60] = True
    vm[n_vocab + 60:n_vocab + 70] = True
    sm[n_vocab + 70:] = True
    return dict(
        edge_src=rng.integers(0, n, n_edges).astype(np.int32),
        edge_dst=rng.integers(0, n, n_edges).astype(np.int32),
        edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
        y=rng.integers(0, 4, n).astype(np.int32),
        train_mask=tm, val_mask=vm, test_mask=sm, n_vocab=n_vocab, n_docs=n_docs)


def _graphs(seed):
    a = _arrays(seed)
    return TextGraph(**a), JaxTextGraph(**a)


def _x(n, h, seed):
    return np.random.default_rng(seed).standard_normal((n, h)).astype(np.float32)


@pytest.mark.parametrize("mode", list(MODES))
def test_restricted_output_and_vjp_match_jax(mode):
    g, jg = _graphs(seed=3)
    rows = np.flatnonzero(g.train_mask)
    x = _x(g.n_nodes, 16, 1)
    cot = _x(len(rows), 16, 2)

    r = build_restricted_adj(g, rows, device="cpu", **MODES[mode])
    xt = torch.tensor(x, requires_grad=True)
    out = spmm_restricted(r, xt)
    (out * torch.tensor(cot)).sum().backward()

    jr = jax_build_restricted(jg, rows, **MODES[mode])
    jout, vjp = jax.vjp(lambda v: jax_spmm_restricted(jr, v), jnp.asarray(x))
    (jgrad,) = vjp(jnp.asarray(cot))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgrad), rtol=1e-4, atol=1e-5)
    assert out.shape == (len(rows), 16)


@pytest.mark.parametrize("mode", list(MODES))
def test_restricted_rows_equal_the_full_products_rows(mode):
    g, _ = _graphs(seed=5)
    rows = np.flatnonzero(g.train_mask)
    r = build_restricted_adj(g, rows, device="cpu", **MODES[mode])
    full = NormAdj.from_graph(g, use_pallas=True, device="cpu")
    x = torch.tensor(_x(g.n_nodes, 8, 3))
    got = spmm_restricted(r, x)
    want = spmm(full, x)[torch.as_tensor(rows)]
    if mode == "csr":
        assert r.res is not None and r.res.fwd.n_rows == len(rows)
        assert r.res.bwd.n_rows == g.n_nodes and r.res.bwd.n_cols == len(rows)
        assert torch.equal(got, want)  # the same edges in the same order
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)


def test_restricted_backward_plan_writes_zeros_on_rows_without_edges():
    g, _ = _graphs(seed=11)
    rows = np.flatnonzero(g.train_mask)
    r = build_restricted_adj(g, rows, use_pallas=True, device="cpu")
    x = torch.tensor(_x(g.n_nodes, 4, 4), requires_grad=True)
    spmm_restricted(r, x).sum().backward()
    # only rows that are an edge's source or a kept row get a gradient
    local = np.zeros(g.n_nodes, bool)
    local[rows] = True
    touched = np.zeros(g.n_nodes, bool)
    touched[np.asarray(g.edge_src)[local[np.asarray(g.edge_dst)]]] = True
    touched |= local
    assert not x.grad[torch.as_tensor(~touched)].any()


def _gcn(g, dropout, seed=1):
    return GCN(g.in_dim, 4, n_hidden_gcn=16, dropout=dropout,
               generator=torch.Generator().manual_seed(seed))


@pytest.mark.parametrize("kw", [dict(), dict(use_pallas=False)], ids=["csr", "segment"])
def test_masked_head_fit_equals_full_fit(kw):
    """Dropout 0.5 on the hidden layer: both runs draw the same masks, and
    the loss sees the same terms."""
    g, _ = _graphs(seed=7)
    full = Trainer(_gcn(g, 0.5), lr=0.05, seed=11, device="cpu", **kw)
    h_full = full.fit(g, epochs=12, n_classes=4)
    masked = Trainer(_gcn(g, 0.5), lr=0.05, seed=11, device="cpu", masked_head=True, **kw)
    h_masked = masked.fit(g, epochs=12, n_classes=4)
    np.testing.assert_allclose([r["loss"] for r in h_masked], [r["loss"] for r in h_full],
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(masked.model.parameters(), full.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert masked.evaluate(g, n_classes=4) == full.evaluate(g, n_classes=4)
    assert masked._adj_out is not None and masked._adj_out.m == int(g.train_mask.sum())


def test_masked_head_fit_matches_jax():
    g, jg = _graphs(seed=9)
    model = _gcn(g, 0.0)
    jtrainer = JaxTrainer(JaxGCN(jg.in_dim, 4, n_hidden_gcn=16, dropout=0.0), lr=0.05,
                          masked_head=True)
    jtrainer.params = jax.tree.map(jnp.asarray, export_params(model))
    jhist = jtrainer.fit(jg, epochs=10, n_classes=4)
    trainer = Trainer(model, lr=0.05, device="cpu", masked_head=True)
    hist = trainer.fit(g, epochs=10, n_classes=4)
    np.testing.assert_allclose([r["loss"] for r in hist], [r["loss"] for r in jhist],
                               rtol=1e-4, atol=1e-6)
    for a, b in zip(jax.tree.leaves(export_params(trainer.model)),
                    jax.tree.leaves(jtrainer.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    assert trainer.evaluate(g, n_classes=4) == pytest.approx(
        jtrainer.evaluate(jg, n_classes=4), abs=1e-6)


def test_masked_head_hybrid_full_operator_takes_the_restricted_chooser():
    g0, _ = _graphs(seed=13)
    # the full hybrid needs weight-symmetric edges: mirror them
    g = dataclasses.replace(
        g0, edge_src=np.concatenate([g0.edge_src, g0.edge_dst]),
        edge_dst=np.concatenate([g0.edge_dst, g0.edge_src]),
        edge_w=np.concatenate([g0.edge_w, g0.edge_w]))
    ref = Trainer(_gcn(g, 0.0), lr=0.05, seed=2, device="cpu").fit(g, epochs=5, n_classes=4)
    t = Trainer(_gcn(g, 0.0), lr=0.05, seed=2, device="cpu", masked_head=True, hybrid_k=64)
    hist = t.fit(g, epochs=5, n_classes=4)
    np.testing.assert_allclose([r["loss"] for r in hist], [r["loss"] for r in ref],
                               rtol=1e-4)


def test_egcn_masked_head_trains_and_jk_refuses():
    g, _ = _graphs(seed=15)
    egcn = EGCN(g.in_dim, 4, embedding_dim=32, n_hidden_gcn=16, dropout=0.5,
                generator=torch.Generator().manual_seed(0))
    hist = Trainer(egcn, lr=0.01, device="cpu", masked_head=True).fit(g, epochs=4,
                                                                         n_classes=4)
    assert np.isfinite([r["loss"] for r in hist]).all()
    jk = JumpingKnowledgeNetwork(g.in_dim, 4, n_hidden_gcn=8,
                                 generator=torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="no masked head"):
        Trainer(jk, device="cpu", masked_head=True)


def test_masked_head_resume_and_early_stopping(tmp_path):
    g, _ = _graphs(seed=17)
    whole = Trainer(_gcn(g, 0.5), lr=0.05, seed=3, device="cpu", masked_head=True)
    whole.fit(g, epochs=10, n_classes=4)

    first = Trainer(_gcn(g, 0.5), lr=0.05, seed=3, device="cpu", masked_head=True)
    first.fit(g, epochs=5, n_classes=4)
    first.save(str(tmp_path / "ckpt"), epoch=5)
    resumed = Trainer(_gcn(g, 0.5, seed=99), lr=0.05, seed=3, device="cpu",
                      masked_head=True)
    start = resumed.restore(str(tmp_path / "ckpt"))
    resumed.fit(g, epochs=10, n_classes=4, start_epoch=start)
    for a, b in zip(resumed.model.parameters(), whole.model.parameters()):
        assert torch.equal(a, b)

    # the reference early-stopping rule fires on the same epoch
    h1 = Trainer(_gcn(g, 0.5), lr=0.5, seed=3, device="cpu").fit(
        g, epochs=40, n_classes=4, early_stopping="reference")
    h2 = Trainer(_gcn(g, 0.5), lr=0.5, seed=3, device="cpu", masked_head=True).fit(
        g, epochs=40, n_classes=4, early_stopping="reference")
    assert len(h1) == len(h2)
