"""The port's tensor parallelism for EGCN's embedding
(pytextgcn_tpu_torch/parallel/tensor.py) against the JAX package's
(pytextgcn_tpu/parallel/tensor.py), as tests/test_tensor_parallel.py holds
JAX's: the layout is the one asked for, the gradients of one step are the
single device's, a run under TP follows the single-device run, and a
checkpoint restores into the TP layout.

One process plays every rank: each rank's model is the full model cut by
``apply_tp`` for a ``Mesh`` of no group, and the all_reduce of the first
contraction is done by hand (every rank's partial, summed). Runs over real
ranks (gloo groups of 2 and 4) are in tests/test_torch_multihost.py.
Tolerances are tests/test_tensor_parallel.py's: gradients rtol 1e-4, atol
1e-6; losses rtol 2e-4, atol 2e-5; parameters rtol 2e-3, atol 2e-4."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.models import EGCN as JaxEGCN
from pytextgcn_tpu.parallel import apply_tp as jax_apply_tp
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.models import EGCN, GCN, export_params, load_jax_params
from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj
from pytextgcn_tpu_torch.parallel import Mesh, apply_tp, tp_param_shardings
from pytextgcn_tpu_torch.train import Trainer
from pytextgcn_tpu_torch.train.metrics import masked_cross_entropy

CPU = torch.device("cpu")
EMBED, HIDDEN, N_CLASSES = 64, 16, 5


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def graphs(n_vocab=40, n_docs=60, n_edges=600, seed=0):
    """tests/test_tensor_parallel.py's graph, for both packages."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    train_mask = np.zeros(n, bool)
    train_mask[n_vocab:n_vocab + 40] = True
    test_mask = np.zeros(n, bool)
    test_mask[n_vocab + 45:] = True
    arrays = dict(edge_src=rng.integers(0, n, n_edges).astype(np.int32),
                  edge_dst=rng.integers(0, n, n_edges).astype(np.int32),
                  edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
                  y=rng.integers(0, N_CLASSES, n).astype(np.int32), train_mask=train_mask,
                  val_mask=np.zeros(n, bool), test_mask=test_mask, n_vocab=n_vocab,
                  n_docs=n_docs)
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def np_params(in_dim, seed=1):
    rng = np.random.default_rng(seed)
    p = lambda *s: (rng.standard_normal(s) * 0.1).astype(np.float32)
    return {"embed": {"w": p(in_dim, EMBED), "b": p(EMBED)},
            "layers": [{"w": p(EMBED, HIDDEN), "b": p(HIDDEN)},
                       {"w": p(HIDDEN, N_CLASSES), "b": p(N_CLASSES)}]}


def egcn(g, dropout=0.0):
    model = EGCN(g.in_dim, N_CLASSES, embedding_dim=EMBED, n_hidden_gcn=HIDDEN,
                 dropout=dropout)
    return load_jax_params(model, np_params(g.in_dim))


def leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in leaves(tree[key],
                                                               f"{prefix}/{key}").items()}
    if isinstance(tree, list):
        return {k: v for i, t in enumerate(tree) for k, v in leaves(t, f"{prefix}/{i}").items()}
    return {prefix: np.asarray(tree)}


def rank_models(model, d):
    return [apply_tp(copy.deepcopy(model), Mesh(None, r, d, CPU)) for r in range(d)]


@pytest.mark.parametrize("d", [2, 8])
def test_embedding_is_cut_by_columns(d):
    g, _ = graphs()
    model = egcn(g)
    assert tp_param_shardings(model) == {"embed.w": 1, "embed.b": 0, "layers.0.w": 0,
                                         "layers.0.b": None, "layers.1.w": None,
                                         "layers.1.b": None}
    assert set(tp_param_shardings(GCN(10, 2)).values()) == {None}
    full = export_params(model)
    for r, m in enumerate(rank_models(model, d)):
        cols = slice(r * EMBED // d, (r + 1) * EMBED // d)
        assert m.tp.cols == (EMBED, cols.start) and m.tp.size == EMBED // d
        np.testing.assert_array_equal(m.embed.w.detach().numpy(), full["embed"]["w"][:, cols])
        np.testing.assert_array_equal(m.embed.b.detach().numpy(), full["embed"]["b"][cols])
        np.testing.assert_array_equal(m.layers[0].w.detach().numpy(),
                                      full["layers"][0]["w"][cols])
        np.testing.assert_array_equal(m.layers[1].w.detach().numpy(),
                                      full["layers"][1]["w"])


def _tp_loss_and_grads(models, adj, feats, y, mask, train=False, seed=0):
    """Every rank's loss and gradients, the all_reduce done by hand: a first
    pass records each rank's partial, the second returns the sum, whose
    gradient reaches the rank's own partial unchanged."""
    partials = []
    for m in models:
        m.tp.all_reduce = lambda t: partials.append(t.detach()) or t
        gen = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            m(adj, feats, train=train, generator=gen)
    total = sum(partials)
    out = []
    for m in models:
        m.tp.all_reduce = lambda t: t + (total - t.detach())
        m.zero_grad()
        gen = torch.Generator().manual_seed(seed)
        loss = masked_cross_entropy(m(adj, feats, train=train, generator=gen), y, mask)
        loss.backward()
        out.append((loss.detach(), {n: p.grad.clone() for n, p in m.named_parameters()}))
    return out


@pytest.mark.parametrize("d", [2, 4, 8])
def test_tp_gradients_match_the_single_device_and_jax(d):
    g, jg = graphs()
    model = egcn(g)
    adj = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    feats = NodeFeatures.from_graph(g, device="cpu")
    y, mask = torch.as_tensor(g.y, dtype=torch.int64), torch.as_tensor(g.train_mask)
    loss = masked_cross_entropy(model(adj, feats), y, mask)
    loss.backward()
    want = {n: p.grad for n, p in model.named_parameters()}
    ranks = _tp_loss_and_grads(rank_models(model, d), adj, feats, y, mask)
    dims = tp_param_shardings(model)
    for name, dim in dims.items():
        got = [grads[name] for _, grads in ranks]
        if dim is None:  # whole on every rank, and equal there
            for t in got:
                torch.testing.assert_close(t, want[name], rtol=1e-4, atol=1e-6)
        else:
            torch.testing.assert_close(torch.cat(got, dim), want[name], rtol=1e-4, atol=1e-6)
    for r_loss, _ in ranks:
        torch.testing.assert_close(r_loss, loss.detach(), rtol=1e-6, atol=1e-7)

    # JAX's gradients under its TP layout (tests/test_tensor_parallel.py:88-107)
    from pytextgcn_tpu.ops import NodeFeatures as JaxFeats
    from pytextgcn_tpu.ops import NormAdj as JaxAdj
    from pytextgcn_tpu.train.metrics import masked_cross_entropy as jax_ce

    jmodel = JaxEGCN(jg.in_dim, N_CLASSES, embedding_dim=EMBED, n_hidden_gcn=HIDDEN,
                     dropout=0.0)
    jadj, jfeats = JaxAdj.from_graph(jg), JaxFeats.from_graph(jg)
    jparams = jax_apply_tp(jax.tree.map(jnp.asarray, np_params(g.in_dim)),
                           JaxMesh(np.array(jax.devices()[:d]), ("model",)))
    jgrads = jax.jit(jax.grad(lambda p: jax_ce(jmodel.apply(p, jadj, jfeats, train=False),
                                               jnp.asarray(g.y), jnp.asarray(g.train_mask))))(
        jparams)
    for path, want_j in leaves(jgrads).items():
        name = {"/embed/w": "embed.w", "/embed/b": "embed.b"}.get(
            path, path.replace("/layers/", "layers.").replace("/", "."))
        np.testing.assert_allclose(want[name].numpy(), want_j, rtol=1e-4, atol=1e-6,
                                   err_msg=path)


def test_dropout_draws_the_single_device_columns():
    # each rank's embedding dropout keeps its columns of the full-width
    # mask: the ranks' masked embeddings side by side are the single
    # device's, step for step of one generator stream
    from pytextgcn_tpu_torch.models.layers import dropout

    x = torch.randn(30, EMBED)
    full = dropout(x, 0.5, True, torch.Generator().manual_seed(4))
    parts = [dropout(x[:, r * 16:(r + 1) * 16], 0.5, True, torch.Generator().manual_seed(4),
                     cols=(EMBED, r * 16)) for r in range(4)]
    torch.testing.assert_close(torch.cat(parts, 1), full, rtol=0, atol=0)


@pytest.mark.parametrize("d", [2, 4])
def test_tp_training_step_with_dropout_matches_single_device(d):
    # dropout 0.5: each rank's loss and gradients equal the single device's
    # at the same generator state (tests/test_tensor_parallel.py:50-85 runs
    # whole fits; those run over real ranks in test_torch_multihost.py)
    g, _ = graphs()
    model = egcn(g, dropout=0.5)
    adj = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    feats = NodeFeatures.from_graph(g, device="cpu")
    y, mask = torch.as_tensor(g.y, dtype=torch.int64), torch.as_tensor(g.train_mask)
    loss = masked_cross_entropy(model(adj, feats, train=True,
                                      generator=torch.Generator().manual_seed(5)), y, mask)
    loss.backward()
    ranks = _tp_loss_and_grads(rank_models(model, d), adj, feats, y, mask, train=True, seed=5)
    for r_loss, grads in ranks:
        torch.testing.assert_close(r_loss, loss.detach(), rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(grads["layers.1.w"], model.layers[1].w.grad, rtol=1e-4,
                                   atol=1e-6)
    torch.testing.assert_close(torch.cat([gr["embed.w"] for _, gr in ranks], 1),
                               model.embed.w.grad, rtol=1e-4, atol=1e-6)


def test_trainer_of_one_rank_follows_jax_tp_trainer():
    # Trainer(tp_mesh=) against JAX's TP trainer on 8 devices from the same
    # numpy parameters at dropout 0 (JAX's TP run equals its single-device
    # run, tests/test_tensor_parallel.py)
    g, jg = graphs()
    tr = Trainer(egcn(g), lr=0.05, seed=7, device="cpu", tp_mesh=Mesh(None, 0, 1, CPU))
    hist = tr.fit(g, epochs=8, n_classes=N_CLASSES)
    jt = JaxTrainer(JaxEGCN(jg.in_dim, N_CLASSES, embedding_dim=EMBED, n_hidden_gcn=HIDDEN,
                            dropout=0.0), lr=0.05, seed=7,
                    tp_mesh=JaxMesh(np.array(jax.devices()[:8]), ("model",)))
    jt.params = jax.tree.map(jnp.asarray, np_params(g.in_dim))
    jhist = jt.fit(jg, epochs=8, n_classes=N_CLASSES)
    np.testing.assert_allclose([h["loss"] for h in hist], [h["loss"] for h in jhist],
                               rtol=2e-4, atol=2e-5)
    got = leaves(export_params(tr.model))
    for path, want in leaves(jt.params).items():
        np.testing.assert_allclose(got[path], want, rtol=2e-3, atol=2e-4, err_msg=path)


def test_checkpoint_is_single_device_layout_and_restores_into_blocks(tmp_path):
    # the saved layout is the single device's; a TP trainer restores it cut
    # to its blocks, optimizer moments included, and resumes as an
    # uninterrupted run (tests/test_tensor_parallel.py:110-150)
    g, _ = graphs()
    one = Mesh(None, 0, 1, CPU)
    t = Trainer(egcn(g), lr=0.05, seed=1, device="cpu", tp_mesh=one)
    t.fit(g, epochs=3, n_classes=N_CLASSES)
    t.save(str(tmp_path / "ck"), epoch=3)
    ref = Trainer(egcn(g), lr=0.05, seed=1, device="cpu")
    ref.fit(g, epochs=3, n_classes=N_CLASSES)
    plain = tmp_path / "plain"
    ref.save(str(plain), epoch=3)
    with np.load(str(tmp_path / "ck") + ".npz") as a, np.load(str(plain) + ".npz") as b:
        for k in (k for k in a.files if k.startswith("p_")):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-7)

    t2 = Trainer(egcn(g), lr=0.05, seed=1, device="cpu", tp_mesh=one)
    start = t2.restore(str(tmp_path / "ck"))
    t2.fit(g, epochs=6, n_classes=N_CLASSES, start_epoch=start)
    t3 = Trainer(egcn(g), lr=0.05, seed=1, device="cpu", tp_mesh=one)
    t3.fit(g, epochs=6, n_classes=N_CLASSES)
    for a, b in zip(t2.model.parameters(), t3.model.parameters()):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-5)

    # rank 1 of 2 restores its own columns, its moments cut alike
    full = t.model.embed.w.detach()
    moments = t.optimizer.state[t.model.embed.w]
    half = Trainer(egcn(g), lr=0.05, seed=1, device="cpu", tp_mesh=Mesh(None, 1, 2, CPU))
    half.restore(str(tmp_path / "ck"))
    torch.testing.assert_close(half.model.embed.w.detach(), full[:, EMBED // 2:], rtol=0, atol=0)
    state = half.optimizer.state[half.model.embed.w]
    for key in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq"):
        assert state[key].shape == half.model.embed.w.shape
        torch.testing.assert_close(state[key], moments[key][:, EMBED // 2:], rtol=0, atol=0)


def test_refusals_name_the_roadmap():
    g, _ = graphs()
    with pytest.raises(ValueError, match=r"does not split evenly.*ROADMAP\.md"):
        Trainer(egcn(g), device="cpu", tp_mesh=Mesh(None, 0, 3, CPU))
    # a tp_mesh beside a graph mesh is taken where both span the same ranks
    # (tests/test_torch_multihost.py trains it), refused elsewhere
    t = Trainer(egcn(g), mesh=Mesh(None, 1, 2, CPU), tp_mesh=Mesh(None, 1, 2, CPU), halo=True)
    assert t.model.tp.lo == EMBED // 2
    with pytest.raises(ValueError, match="spans the same ranks"):
        Trainer(egcn(g), mesh=Mesh(None, 0, 2, CPU), tp_mesh=Mesh(None, 1, 2, CPU))
    with pytest.raises(ValueError, match="fit_minibatch does not run a tp_mesh"):
        Trainer(egcn(g), device="cpu", tp_mesh=Mesh(None, 0, 1, CPU)).fit_minibatch(g)
