"""The port's neighborhood mini-batching (``data/batching.py``,
``Trainer.fit_minibatch``) against the JAX package's and against its own
full-graph training: the batcher's arrays bit for bit, batch-node logits equal
to the full graph's, the plan built from tensors equal to the numpy one, and
training trajectories from shared parameters at dropout 0."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.data.batching import NeighborhoodBatcher as JaxBatcher
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.ops import NodeFeatures as JaxNodeFeatures
from pytextgcn_tpu.ops import NormAdj as JaxNormAdj
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch import Text2Graph, TextGraph
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.data.batching import NeighborhoodBatcher
from pytextgcn_tpu_torch.experiments import flat, mlp, perlabel, perlevel
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj, spmm
from pytextgcn_tpu_torch.ops import spmm_cuda
from pytextgcn_tpu_torch.train import Trainer

PLAN_FIELDS = ("row_ptr", "pairs", "seg_ptr", "seg_row", "seg_slot", "split_row", "split_ptr")


def random_graphs(seed, n_vocab=40, n_docs=50, n_edges=600):
    """tests/test_batching.py's random graph (asymmetric, multi-edges), as
    the port's and the JAX package's ``TextGraph``."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    train_mask = np.zeros(n, bool)
    train_mask[n_vocab : n_vocab + 30] = True
    fields = dict(
        edge_src=rng.integers(0, n, n_edges).astype(np.int32),
        edge_dst=rng.integers(0, n, n_edges).astype(np.int32),
        edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
        y=rng.integers(0, 3, n).astype(np.int32),
        train_mask=train_mask, val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n_vocab, n_docs=n_docs,
    )
    return TextGraph(**fields), JaxTextGraph(**fields)


@pytest.fixture(scope="module")
def corpus_graph():
    """A Text2Graph graph (hub words, symmetric weights) with a test split."""
    docs, labels = synthetic_corpus(n_docs=120, n_classes=4, seed=3)
    test_idx = np.random.default_rng(0).choice(120, 24, replace=False)
    return Text2Graph(min_df=1, window_size=5).fit_transform(docs, labels, test_idx=test_idx)


def assert_plans_equal(a, b):
    for f in PLAN_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    assert (a.n_rows, a.n_cols, a.n_partials) == (b.n_rows, b.n_cols, b.n_partials)


@pytest.mark.parametrize("n_hops", [1, 2])
@pytest.mark.parametrize("pad_pow2", [True, False], ids=["padded", "unpadded"])
def test_batcher_matches_jax_over_two_epochs(pad_pow2, n_hops):
    g, jg = random_graphs(0)
    batcher = NeighborhoodBatcher(g, batch_size=16, n_hops=n_hops, seed=1, pad_pow2=pad_pow2)
    jbatcher = JaxBatcher(jg, batch_size=16, n_hops=n_hops, seed=1, pad_pow2=pad_pow2)
    assert len(batcher) == len(jbatcher) == 2
    for _ in range(2):  # each epoch draws a fresh permutation
        subs, jsubs = list(batcher), list(jbatcher)
        assert len(subs) == len(jsubs) == 2
        for sub, jsub in zip(subs, jsubs):
            for f in dataclasses.fields(sub):
                a, b = getattr(sub, f.name), getattr(jsub, f.name)
                if isinstance(a, np.ndarray):
                    assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f.name
                else:
                    assert a == b, f.name


def _jax_full_logits(jg, params, n_classes):
    model = JaxGCN(jg.in_dim, n_classes, n_hidden_gcn=8, dropout=0.0)
    return np.asarray(model.apply(jax.tree.map(jnp.asarray, params), JaxNormAdj.from_graph(jg),
                                  JaxNodeFeatures.from_graph(jg), train=False))


@pytest.mark.parametrize("pad_pow2,real_only", [(False, True), (True, True), (True, False)],
                         ids=["unpadded", "padded-real-only", "padded-all-rows"])
@pytest.mark.parametrize("which", ["random", "corpus"])
def test_batch_logits_match_full_graph_and_jax(corpus_graph, which, pad_pow2, real_only):
    if which == "random":
        g, _ = random_graphs(0)
        n_classes = 3
    else:
        g = corpus_graph
        n_classes = 4
    jg = JaxTextGraph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(JaxTextGraph)
                         if hasattr(g, f.name)})
    model = GCN(g.in_dim, n_classes, n_hidden_gcn=8, dropout=0.0,
                generator=torch.Generator().manual_seed(4))
    feats_full = NodeFeatures.from_graph(g, device="cpu")
    with torch.no_grad():
        full = model(NormAdj.from_graph(g, use_pallas=True, device="cpu"), feats_full).numpy()
    jfull = _jax_full_logits(jg, export_params(model), n_classes)

    seen = []
    batcher = NeighborhoodBatcher(g, batch_size=16, n_hops=2, seed=1, pad_pow2=pad_pow2)
    for sub in batcher:
        adj = sub.to_adj("cpu", real_only=real_only)
        assert adj.n_nodes == (sub.n_real_nodes if real_only else len(sub.nodes))
        assert adj.plan.fwd.n_edges == sub.n_real_edges
        nodes = torch.as_tensor(sub.nodes[:adj.n_nodes])
        with torch.no_grad():
            out = model(adj, feats_full.subgraph(nodes)).numpy()
            if not real_only:
                # the padded rows have no edges and no self-loop: exact zeros
                x = torch.randn(adj.n_nodes, 5)
                assert not spmm_cuda.spmm_csr(adj.plan.fwd, x)[sub.n_real_nodes:].any()
                assert not spmm(adj, x)[sub.n_real_nodes:].any()
        locs = sub.batch_local[sub.batch_local >= 0]
        ids = sub.nodes[locs]
        seen.extend(ids.tolist())
        np.testing.assert_allclose(out[locs], full[ids], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(out[locs], jfull[ids], rtol=1e-4, atol=1e-5)
    assert sorted(seen) == np.flatnonzero(g.train_mask).tolist()


def test_segment_path_subgraph_has_no_plan():
    g, _ = random_graphs(0)
    sub = next(iter(NeighborhoodBatcher(g, batch_size=16, seed=1)))
    adj = sub.to_adj("cpu", use_pallas=False)
    planned = sub.to_adj("cpu")
    assert adj.plan is None
    x = torch.randn(adj.n_nodes, 6)
    torch.testing.assert_close(spmm(adj, x), spmm(planned, x), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("n,e,hubs", [(0, 0, False), (50, 0, False), (300, 2000, False),
                                      (300, 5000, True), (2000, 40_000, True)],
                         ids=["no-rows", "no-edges", "uniform", "hubs", "hubs-large"])
def test_tensor_plan_equals_numpy_plan(n, e, hubs):
    """Random graphs with empty rows and, with hubs, rows of thousands of
    edges (cut into segments of 256)."""
    rng = np.random.default_rng(n + e)
    src = rng.integers(0, max(n, 1), e)
    if hubs:  # most edges into 3 rows, most rows empty
        dst = np.concatenate([rng.integers(0, 3, e - e // 10), rng.integers(0, n, e // 10)])
    else:
        dst = rng.integers(0, max(n, 1), e)
    w = rng.standard_normal(e).astype(np.float32)
    host = spmm_cuda.build_plan_from_arrays(src, dst, w, n)
    tensors = spmm_cuda.build_plan_from_arrays(torch.as_tensor(src), torch.as_tensor(dst),
                                               torch.as_tensor(w), n)
    assert_plans_equal(tensors.fwd, host.fwd)
    assert_plans_equal(tensors.bwd, host.bwd)
    if hubs:
        assert host.fwd.n_partials > 0


def test_tensor_plan_checks_its_input():
    with pytest.raises(ValueError, match="out of range"):
        spmm_cuda.build_csr_plan(torch.tensor([0, 5]), torch.tensor([0, 1]), torch.ones(2),
                                 5, 5, "cpu")
    with pytest.raises(ValueError, match="out of range"):
        spmm_cuda.build_csr_plan(torch.tensor([0, 1]), torch.tensor([-1, 1]), torch.ones(2),
                                 5, 5, "cpu")


def test_subgraph_plan_equals_host_plan(corpus_graph):
    sub = next(iter(NeighborhoodBatcher(corpus_graph, batch_size=16, seed=2, pad_pow2=True)))
    e = sub.n_real_edges
    host = spmm_cuda.build_plan_from_arrays(sub.edge_src[:e], sub.edge_dst[:e],
                                            sub.edge_w[:e], sub.n_real_nodes)
    plan = sub.to_adj("cpu").plan
    assert_plans_equal(plan.fwd, host.fwd)
    assert_plans_equal(plan.bwd, host.bwd)


def _params(model):
    return [p.detach().numpy() for p in model.parameters()]


def test_one_batch_of_every_train_doc_equals_fit():
    """``fit_minibatch`` with one batch spanning every train document (and
    n_hops = the model's depth) gives ``fit``'s parameters after 5 epochs at
    dropout 0 (tests/test_batching.py:86-106)."""
    g, _ = random_graphs(1)

    def make_trainer():
        model = GCN(g.in_dim, 3, n_hidden_gcn=8, dropout=0.0,
                    generator=torch.Generator().manual_seed(5))
        return Trainer(model, lr=0.05, seed=5, device="cpu")

    tr_full = make_trainer()
    tr_full.fit(g, epochs=5, n_classes=3)
    tr_mb = make_trainer()
    n_train = int(np.sum(g.train_mask))
    hist = tr_mb.fit_minibatch(g, epochs=5, batch_size=n_train, n_hops=2, n_classes=3)
    assert len(hist) == 5 and len(tr_mb.minibatch_seconds) == 5
    for a, b in zip(_params(tr_mb.model), _params(tr_full.model)):
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_fit_minibatch_matches_jax_trajectory(corpus_graph):
    """Several shuffled batches an epoch from shared parameters at dropout
    0: the same batches, mean losses and parameters as the JAX trainer's
    ``fit_minibatch`` (which pads its batches; the port does not)."""
    g = corpus_graph
    jg = JaxTextGraph(**{f.name: getattr(g, f.name) for f in dataclasses.fields(JaxTextGraph)
                         if hasattr(g, f.name)})
    model = GCN(g.in_dim, 4, n_hidden_gcn=16, dropout=0.0,
                generator=torch.Generator().manual_seed(6))
    jtrainer = JaxTrainer(JaxGCN(jg.in_dim, 4, n_hidden_gcn=16, dropout=0.0), lr=0.05, seed=3)
    jtrainer.params = jax.tree.map(jnp.asarray, export_params(model))
    jhist = jtrainer.fit_minibatch(jg, epochs=3, batch_size=24, n_classes=4)

    trainer = Trainer(model, lr=0.05, seed=3, device="cpu")
    hist = trainer.fit_minibatch(g, epochs=3, batch_size=24, n_classes=4)
    n_batches = -(-int(np.sum(g.train_mask)) // 24)
    assert n_batches > 1 and len(trainer.minibatch_seconds) == 3 * n_batches
    assert all(set(t) == {"batcher", "plan", "step"} for t in trainer.minibatch_seconds)
    np.testing.assert_allclose([r["loss"] for r in hist], [r["loss"] for r in jhist],
                               rtol=1e-4)
    want = export_params(trainer.model)
    for a, b in zip(jax.tree.leaves(want), jax.tree.leaves(jtrainer.params)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)


def test_minibatch_loss_falls():
    """Real mini-batches (several an epoch, shuffled, dropout on) fit the
    training documents (tests/test_batching.py:109-124)."""
    g, _ = random_graphs(2, n_vocab=40, n_docs=60, n_edges=500)
    model = GCN(g.in_dim, 3, n_hidden_gcn=16, dropout=0.1,
                generator=torch.Generator().manual_seed(0))
    trainer = Trainer(model, lr=0.05, seed=0, device="cpu")
    hist = trainer.fit_minibatch(g, epochs=40, batch_size=8, n_classes=3)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert trainer.evaluate(g, mask=g.train_mask, n_classes=3)["accuracy"] > 0.9


@pytest.mark.parametrize("kwargs", [dict(masked_head=True), dict(hybrid_k=16),
                                    dict(plan_cache="plans")],
                         ids=["masked-head", "hybrid", "plan-cache"])
def test_fit_minibatch_refuses_full_graph_options(kwargs):
    g, _ = random_graphs(0)
    trainer = Trainer(GCN(g.in_dim, 3, n_hidden_gcn=8), device="cpu", **kwargs)
    with pytest.raises(ValueError, match="fit_minibatch does not run"):
        trainer.fit_minibatch(g, batch_size=8)


def test_flat_driver_minibatches_and_writes_its_row(tmp_path):
    out = tmp_path / "results.csv"
    res = flat.main(["--device", "cpu", "--train-batch-size", "8", "--train-epochs", "3",
                     "--train-verbose", "0", "--result-file", str(out)])
    losses = [rec["loss"] for rec in res["history"]]
    assert len(losses) == 3 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert len(res["trainer"].minibatch_seconds) == 3 * 35  # 280 train documents
    assert res["accuracy"] > 0.5
    lines = out.read_text().splitlines()
    assert lines[0] == "seed,model,hierarchy,f1-macro,accuracy"
    assert lines[1].startswith("44,GCN,flat,")


@pytest.mark.parametrize("driver", [perlevel, perlabel, mlp])
def test_drivers_that_do_not_minibatch_refuse_it(driver):
    with pytest.raises(SystemExit, match="only the flat driver mini-batches"):
        driver.main(["--device", "cpu", "--train-batch-size", "8"])


@pytest.mark.parametrize("flag", [["--train-hybrid-k", "128"], ["--train-ep", "true"],
                                  ["--train-plan-cache", "plans"],
                                  ["--train-early-stopping", "reference"]])
def test_flat_driver_refuses_options_it_would_not_run(flag):
    with pytest.raises(SystemExit, match="does not run"):
        flat.main(["--device", "cpu", "--train-batch-size", "8", *flag])
