"""The port's EGCN and JK network, its checkpoints and its resume against
the JAX package, from shared numpy inputs and parameters (device 'cpu':
the CSR kernel's plain version), plus the settings the port still refuses.

Tolerances, relative to the largest magnitude of the compared array (the
logits; for gradients, all of the model's gradients together, since some
are analytically zero, e.g. the attention bias's): 1e-5, and 1e-4 for EGCN,
whose 2000-wide embedding feeds a 2000-term product.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu import Text2Graph as JaxText2Graph
from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.models import EGCN as JaxEGCN
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.models import JumpingKnowledgeNetwork as JaxJK
from pytextgcn_tpu.ops import NodeFeatures as JaxNodeFeatures
from pytextgcn_tpu.ops import NormAdj as JaxNormAdj
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu.train import metrics as jax_metrics
from pytextgcn_tpu.train.checkpoint import load_checkpoint as jax_load_checkpoint
from pytextgcn_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from pytextgcn_tpu_torch.config import check_ported, make_model, parse_config
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.experiments import flat
from pytextgcn_tpu_torch.models import (EGCN, GCN, JumpingKnowledgeNetwork, export_params,
                                        load_jax_params)
from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj
from pytextgcn_tpu_torch.train import Trainer, metrics
from pytextgcn_tpu_torch.train.checkpoint import flatten, load_checkpoint, unflatten

RTOL = 1e-5  # of the largest magnitude
EGCN_RTOL = 1e-4  # the 2000-term product
EMBED = 2000


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test run puts several workers on one machine; torch's default
    of one intra-op thread per core in each of them oversubscribes the
    cores and slows these small CPU runs many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph_pair(rng, n_vocab=60, n_docs=80, n_edges=900, n_classes=5, hier=0):
    n = n_vocab + n_docs
    arrays = dict(
        edge_src=rng.integers(0, n, n_edges).astype(np.int32),
        edge_dst=rng.integers(0, n, n_edges).astype(np.int32),
        edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
        y=np.r_[np.zeros(n_vocab, np.int32), rng.integers(0, n_classes, n_docs).astype(np.int32)],
        train_mask=np.r_[np.zeros(n_vocab, bool), rng.random(n_docs) < 0.6],
        val_mask=np.zeros(n, bool), test_mask=np.r_[np.zeros(n_vocab, bool),
                                                     rng.random(n_docs) < 0.3],
        n_vocab=n_vocab, n_docs=n_docs,
        hierarchy_feats=(np.eye(hier, dtype=np.float32)[rng.integers(0, hier, n_docs)]
                         if hier else None),
    )
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def _jax_model(name, in_dim, out_dim, hidden=12, dropout=0.0):
    if name == "gcn":
        return JaxGCN(in_dim, out_dim, n_hidden_gcn=hidden, dropout=dropout)
    if name == "egcn":
        return JaxEGCN(in_dim, out_dim, embedding_dim=EMBED, n_hidden_gcn=hidden,
                       dropout=dropout)
    return JaxJK(in_dim, out_dim, n_hidden_gcn=hidden, dropout=dropout)


def _port_model(name, in_dim, out_dim, hidden=12, dropout=0.0, seed=0):
    gen = torch.Generator().manual_seed(seed)
    kw = dict(n_hidden_gcn=hidden, dropout=dropout, generator=gen)
    if name == "gcn":
        return GCN(in_dim, out_dim, **kw)
    if name == "egcn":
        return EGCN(in_dim, out_dim, embedding_dim=EMBED, **kw)
    return JumpingKnowledgeNetwork(in_dim, out_dim, **kw)


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, rtol, scale=None):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=0, atol=rtol * scale + 1e-12)


@pytest.mark.parametrize("hier", [0, 3], ids=["flat", "hierarchy"])
@pytest.mark.parametrize("name", ["egcn", "jk"])
def test_logits_and_grads_match_jax(name, hier):
    rng = np.random.default_rng(1)
    g, jg = _graph_pair(rng, hier=hier)
    jmodel = _jax_model(name, g.in_dim, 5)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(3)))
    jadj, jfeats = JaxNormAdj.from_graph(jg), JaxNodeFeatures.from_graph(jg)
    y, mask = jnp.asarray(jg.y), jnp.asarray(jg.train_mask)

    def jloss(p):
        return jax_metrics.masked_cross_entropy(jmodel.apply(p, jadj, jfeats), y, mask)

    jparams = jax.tree.map(jnp.asarray, params)
    jlogits = jmodel.apply(jparams, jadj, jfeats)
    jgrads = _np_tree(jax.grad(jloss)(jparams))

    model = load_jax_params(_port_model(name, g.in_dim, 5), params)
    logits = model(NormAdj.from_graph(g, device="cpu"), NodeFeatures.from_graph(g, device="cpu"),
                   train=True)  # dropout 0: train mode changes nothing
    metrics.masked_cross_entropy(logits, torch.as_tensor(g.y).long(),
                                 torch.as_tensor(g.train_mask)).backward()

    rtol = EGCN_RTOL if name == "egcn" else RTOL
    _close(logits.detach().numpy(), jlogits, rtol)
    grads = export_params_of_grads(model)
    assert flatten(grads) and len(flatten(grads)) == len(flatten(jgrads))
    scale = max(float(np.abs(w).max()) for w in flatten(jgrads))
    for got, want in zip(flatten(grads), flatten(jgrads)):
        _close(got, want, rtol, scale)


def export_params_of_grads(model):
    """The gradients in the JAX parameter tree's layout."""
    saved = [p.detach().clone() for p in model.parameters()]
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    tree = export_params(model)
    with torch.no_grad():
        for p, s in zip(model.parameters(), saved):
            p.copy_(s)
    return tree


@pytest.mark.parametrize("lr", [0.05, 0.005])
def test_egcn_trajectory_matches_jax(lr):
    """EGCN trained by both Trainers (their flat default, amsgrad) from
    shared parameters at dropout 0: the losses agree within 1e-4 relative
    at each step. At the protocols' lr 0.05 both climb more than 3x in the
    first epochs, at 0.005 both fall at every step: the climb belongs to
    the model and its optimizer, not to the port."""
    docs, labels = synthetic_corpus(n_docs=200, n_classes=4, seed=7)
    rng = np.random.default_rng(0)
    test_idx = rng.choice(200, 40, replace=False)
    val_idx = np.setdiff1d(rng.choice(200, 30, replace=False), test_idx)
    kw = dict(min_df=1, window_size=5)
    g = Text2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx, val_idx=val_idx)
    jg = JaxText2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx, val_idx=val_idx)
    model = EGCN(g.in_dim, 4, embedding_dim=EMBED, n_hidden_gcn=16, dropout=0.0,
                 generator=torch.Generator().manual_seed(1))
    jtrainer = JaxTrainer(JaxEGCN(jg.in_dim, 4, embedding_dim=EMBED, n_hidden_gcn=16,
                                  dropout=0.0), lr=lr)
    jtrainer.params = jax.tree.map(jnp.asarray, export_params(model))
    jlosses = np.array([r["loss"] for r in jtrainer.fit(jg, epochs=8, n_classes=4,
                                                        eval_every=100)])
    losses = np.array([r["loss"] for r in Trainer(model, lr=lr, device="cpu").fit(
        g, epochs=8, n_classes=4, eval_every=100)])
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    for run in (losses, jlosses):
        if lr == 0.05:
            assert run.max() > 3 * run[0]
        else:
            assert (np.diff(run) < 0).all()


@pytest.mark.parametrize("name", ["gcn", "egcn", "jk"])
def test_param_tree_round_trip_and_shape_checks(name):
    jmodel = _jax_model(name, 30, 4)
    params = _np_tree(jmodel.init(jax.random.PRNGKey(0)))
    model = load_jax_params(_port_model(name, 30, 4), params)
    out = export_params(model)
    assert jax.tree.structure(out) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        load_jax_params(_port_model(name, 31, 4), params)
    broken = dict(params)
    broken.pop("layers")
    with pytest.raises(ValueError, match="keys"):
        load_jax_params(_port_model(name, 30, 4), broken)
    # the port's own init is seeded and JAX-shaped
    a, b = (export_params(_port_model(name, 30, 4, seed=7)) for _ in range(2))
    assert jax.tree.structure(a) == jax.tree.structure(params)
    for x, y, p in zip(jax.tree.leaves(a), jax.tree.leaves(b), jax.tree.leaves(params)):
        np.testing.assert_array_equal(x, y)
        assert x.shape == p.shape


def test_egcn_drops_out_after_every_layer_including_the_logits():
    """The reference quirk: in training, dropout zeroes logits too, whose
    bias alone would keep them off zero; in evaluation none is zero."""
    rng = np.random.default_rng(4)
    g, _ = _graph_pair(rng)
    adj, feats = NormAdj.from_graph(g, device="cpu"), NodeFeatures.from_graph(g, device="cpu")
    gen = torch.Generator().manual_seed(0)
    model = _port_model("egcn", g.in_dim, 5, dropout=0.5)
    with torch.no_grad():
        model.layers[-1].b.fill_(1.0)
        logits = model(adj, feats, train=True, generator=gen)
        assert (logits == 0).float().mean() > 0.3
        assert not (model(adj, feats) == 0).any()


def test_flatten_is_jax_order():
    tree = {"b": [{"z": 1, "a": 2}, 3], "a": {"y": 4, "x": 5}}
    assert flatten(tree) == jax.tree.leaves(tree) == [5, 4, 2, 1, 3]
    assert unflatten(tree, flatten(tree)) == {"a": {"x": 5, "y": 4},
                                              "b": [{"a": 2, "z": 1}, 3]}


@pytest.mark.parametrize("name", ["gcn", "egcn", "jk"])
def test_jax_checkpoint_loads_into_the_port(name, tmp_path):
    rng = np.random.default_rng(5)
    g, jg = _graph_pair(rng)
    jmodel = _jax_model(name, g.in_dim, 5, dropout=0.5)
    params = jmodel.init(jax.random.PRNGKey(9))
    path = str(tmp_path / "jax_ckpt")
    jax_save_checkpoint(path, params, meta={"epoch": 7})
    jlogits = jmodel.apply(params, JaxNormAdj.from_graph(jg), JaxNodeFeatures.from_graph(jg))

    trainer = Trainer(_port_model(name, g.in_dim, 5, dropout=0.5, seed=1), device="cpu")
    assert trainer.restore(path) == 7  # params only: no torch state in a JAX file
    logits = trainer.predict_logits(g)
    _close(logits.numpy(), jlogits, EGCN_RTOL if name == "egcn" else RTOL)
    # and the port's parameter file loads into the JAX package
    trainer.save(str(tmp_path / "port_ckpt"), epoch=3)
    back, _ = jax_load_checkpoint(str(tmp_path / "port_ckpt"), params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    meta = json.loads((tmp_path / "port_ckpt.json").read_text())["meta"]
    assert meta["epoch"] == 3 and meta["model"] == type(trainer.model).__name__


@pytest.mark.parametrize("name", ["gcn", "egcn", "jk"])
def test_resume_is_bit_exact(name, tmp_path):
    """fit 4 epochs, save, restore into a fresh trainer, fit on to 9: the
    parameters, and the loss history after the resume point, equal bit for
    bit those of one uninterrupted 9-epoch fit (dropout on, amsgrad)."""
    rng = np.random.default_rng(6)
    g, _ = _graph_pair(rng)

    def trainer(seed=0):
        model = _port_model(name, g.in_dim, 5, dropout=0.5, seed=seed)
        return Trainer(model, lr=0.05, seed=11, device="cpu")

    whole = trainer()
    hist = whole.fit(g, epochs=9, n_classes=5)

    first = trainer()
    first.fit(g, epochs=4, n_classes=5)
    first.save(str(tmp_path / "ck"), epoch=4)
    second = trainer(seed=99)  # different init: all of it comes from the file
    with pytest.raises(ValueError, match="restore"):
        second.fit(g, epochs=9, n_classes=5, start_epoch=4)
    start = second.restore(str(tmp_path / "ck"))
    assert start == 4
    rest = second.fit(g, epochs=9, n_classes=5, start_epoch=start)

    assert [r["loss"] for r in rest] == [r["loss"] for r in hist[4:]]
    for a, b in zip(whole.model.parameters(), second.model.parameters()):
        assert torch.equal(a, b)
    _, state = load_checkpoint(str(tmp_path / "ck"), export_params(first.model))
    assert set(state) == {"optimizer", "generator"}


def test_share_adjacency_only_with_equal_aggregation():
    rng = np.random.default_rng(7)
    g, _ = _graph_pair(rng)
    a = Trainer(GCN(g.in_dim, 5, n_hidden_gcn=8), device="cpu")
    a.prepare(g)
    b = Trainer(GCN(g.in_dim, 5, n_hidden_gcn=8), device="cpu")
    b.share_adjacency(a)
    assert b._adj is a._adj
    g2 = dataclasses.replace(g, y=np.zeros_like(g.y))
    assert b.prepare(g2)[0] is a._adj  # same edges: kept
    c = Trainer(GCN(g.in_dim, 5, n_hidden_gcn=8), device="cpu", use_pallas=False)
    c.share_adjacency(a)
    assert c._adj is None
    d = Trainer(GCN(g.in_dim, 5, n_hidden_gcn=8), device="cpu")
    d.share_adjacency(a)
    g3 = dataclasses.replace(g, edge_w=g.edge_w.copy())
    assert d.prepare(g3)[0] is not a._adj  # other edge arrays: rebuilt


@pytest.mark.parametrize("flag", [
    ["--train-sharding", "hybrid", "--train-hybrid-f32-mode", "split2"],
    ["--train-batch-size", "1", "--train-hybrid-k", "128"],
    ["--train-sharding", "halo", "--train-n-devices", "2", "--train-plan-cache", "plans"],
    ["--train-sharding", "allgather", "--train-n-devices", "2", "--train-hybrid-k", "128"],
])
def test_check_ported_still_refuses(flag):
    with pytest.raises(SystemExit, match="ROADMAP.md"):
        check_ported(parse_config(flag))


@pytest.mark.parametrize("flag", [["--model-model", "egcn"], ["--model-model", "jk"],
                                  ["--save-model", "ck"],
                                  ["--train-ep", "true", "--model-model", "jk"],
                                  ["--train-ep", "true", "--model-model", "egcn"],
                                  ["--train-debug-checks", "true"],
                                  ["--train-optimizer", "optax_amsgrad"],
                                  ["--dataset", "amazon"], ["--dataset", "dbpedia"],
                                  ["--dataset", "csv"], ["--train-batch-size", "64"],
                                  ["--graph-backend", "device"],
                                  ["--train-sharding", "hybrid", "--train-n-devices", "2"],
                                  ["--train-sharding", "halo", "--train-n-devices", "2",
                                   "--train-masked-head", "true"],
                                  # ROADMAP.md §1 item 4c, ported
                                  ["--train-ep", "true", "--train-n-devices", "2"],
                                  ["--graph-backend", "sharded"],
                                  ["--train-ep", "true", "--train-n-devices", "4"]])
def test_check_ported_accepts_egcn_jk_and_save_model(flag):
    check_ported(parse_config(flag))


def test_check_ported_sends_the_mlp_to_its_driver():
    cfg = parse_config(["--model-model", "mlp"])
    with pytest.raises(SystemExit, match="experiments/mlp.py"):
        check_ported(cfg)
    check_ported(cfg, graph=False)


@pytest.mark.parametrize("name", ["egcn", "jk"])
def test_flat_experiment_runs_the_model_and_saves_it(name, tmp_path):
    out, ck = tmp_path / "results.csv", tmp_path / "model"
    res = flat.main(["--device", "cpu", "--train-epochs", "12", "--train-verbose", "0",
                     "--model-model", name, "--model-embedding-dim", "200",
                     "--model-dropout", "0.3", "--result-file", str(out),
                     "--save-model", str(ck)])
    losses = [rec["loss"] for rec in res["history"]]
    assert len(losses) == 12 and np.isfinite(losses).all() and losses[-1] < losses[0]
    assert out.read_text().splitlines()[1].startswith(f"44,{name.upper()},flat,")
    cfg = parse_config(["--model-model", name, "--model-embedding-dim", "200"])
    model = make_model(cfg.model, 1, 1)
    assert type(model).__name__ == json.loads((tmp_path / "model.json").read_text())[
        "meta"]["model"]
