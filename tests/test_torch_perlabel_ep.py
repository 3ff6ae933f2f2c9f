"""The port's batched per-label ensemble (``train_per_label(ep=True)``, the
JAX package's expert-parallel step on one device) against its sequential
ensemble and against the JAX package's EP step on a one-device CPU mesh.

The members' SpMMs run as one over ``[N, M * H]`` (device 'cpu': the CSR
kernel's plain version). Tolerance rtol 2e-4, atol 2e-5, the band of
tests/test_perlabel_ep.py:39-56: the batched products and reductions sum
in other orders than the members' own.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.hierarchy import train_per_label as jax_train_per_label
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.parallel import make_mesh
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.hierarchy import eval_per_label, train_per_label
from pytextgcn_tpu_torch.hierarchy.perlabel import (_PAD_BIAS, Ensemble, _batched_member_preds,
                                                    _stack_members, _stacked_logits)
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj
from pytextgcn_tpu_torch.parallel import Mesh
from pytextgcn_tpu_torch.train import Trainer

TOL = dict(rtol=2e-4, atol=2e-5)
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ragged_corpus():
    # 5 child classes over 2 parents: members of 3 and 2 classes
    docs, child, parent = synthetic_corpus(n_docs=150, n_classes=5, n_parents=2, seed=13)
    rng = np.random.default_rng(2)
    test_idx = rng.choice(len(docs), len(docs) // 5, replace=False)
    g = Text2Graph(min_df=1, window_size=5).fit_transform(docs, child, test_idx=test_idx)
    return g, np.asarray(child), np.asarray(parent)


def _factory(dropout=0.5, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return lambda d_in, d_out: GCN(d_in, d_out, n_hidden_gcn=16, dropout=dropout,
                                   generator=gen)


def _assert_members_close(a, b):
    for ta, tb in zip(a, b):
        for pa, pb in zip(ta.model.parameters(), tb.model.parameters()):
            np.testing.assert_allclose(pa.detach().numpy(), pb.detach().numpy(), **TOL)


def test_ep_matches_sequential_ragged(ragged_corpus):
    """Dropout on: each member draws from its own sequential stream."""
    g, child, parent = ragged_corpus
    seq = train_per_label(g, child, parent, _factory(), epochs=25, seed=3,
                          trainer_kwargs=CPU)
    ep = train_per_label(g, child, parent, _factory(), epochs=25, seed=3, ep=True,
                         trainer_kwargs=CPU)
    assert ep["mapping"] == seq["mapping"]
    assert [len(h) for h in ep["histories"]] == [25, 25]
    _assert_members_close(seq["trainers"], ep["trainers"])
    for hs, he in zip(seq["histories"], ep["histories"]):
        np.testing.assert_allclose([r["loss"] for r in he], [r["loss"] for r in hs], **TOL)
    m_seq = eval_per_label(g, child, parent, seq["trainers"], seq["mapping"])
    m_ep = eval_per_label(g, child, parent, ep["trainers"], ep["mapping"])
    assert m_seq["accuracy"] == pytest.approx(m_ep["accuracy"], abs=1e-6)


def test_ep_matches_jax_ep_on_a_one_device_mesh(ragged_corpus):
    """Shared initial parameters, dropout 0: the JAX members' ``init``
    returns the port members' parameters."""
    g, child, parent = ragged_corpus
    ep = train_per_label(g, child, parent, _factory(dropout=0.0, seed=5), epochs=20, seed=3,
                         ep=True, trainer_kwargs=CPU)
    fresh = _factory(dropout=0.0, seed=5)  # the same initial parameters again
    inits = [export_params(fresh(g.in_dim, len(ep["mapping"][c]))) for c in range(2)]
    made = []

    class _Fixed(JaxGCN):
        def init(self, key):
            return jax.tree.map(jnp.asarray, self.params)

    def jax_factory(d_in, d_out):
        model = _Fixed(d_in, d_out, n_hidden_gcn=16, dropout=0.0)
        model.params = inits[len(made)]
        made.append(model)
        return model

    jep = jax_train_per_label(g, child, parent, jax_factory, epochs=20, seed=3,
                              mesh=make_mesh(1, axis="ensemble"))
    assert jep["mapping"] == ep["mapping"]
    for t, jt in zip(ep["trainers"], jep["trainers"]):
        for a, b in zip(jax.tree.leaves(export_params(t.model)), jax.tree.leaves(jt.params)):
            np.testing.assert_allclose(a, np.asarray(b), **TOL)


def test_batched_eval_matches_member_loop(ragged_corpus):
    g, child, parent = ragged_corpus
    out = train_per_label(g, child, parent, _factory(), epochs=20, seed=1,
                          trainer_kwargs=CPU)
    trainers, mapping = out["trainers"], out["mapping"]
    c_list = [len(mapping[c]) for c in range(len(trainers))]
    y_nodes = np.zeros(g.n_nodes, np.int32)
    y_nodes[g.n_vocab:] = child
    g_eval = dataclasses.replace(g, y=y_nodes)
    batched = _batched_member_preds(g_eval, trainers, c_list)
    assert batched is not None and batched.shape == (len(trainers), g.n_docs)
    for c, t in enumerate(trainers):
        loop = t.predict_logits(g_eval)[g.n_vocab:].argmax(dim=-1).numpy()
        np.testing.assert_array_equal(batched[c], loop)


def test_padded_logits_get_exactly_zero_gradient(ragged_corpus):
    g, child, parent = ragged_corpus
    make = _factory()
    models = [make(g.in_dim, 3), make(g.in_dim, 2)]
    params = _stack_members(models, [3, 2], torch.device("cpu"))
    assert torch.equal(params[3][1, 2], torch.tensor(_PAD_BIAS))
    adj = NormAdj.from_graph(g, use_pallas=True, device="cpu")
    feats = NodeFeatures.from_graph(g, device="cpu")
    gens = [torch.Generator().manual_seed(0) for _ in models]
    logits = _stacked_logits(params, models[0], adj, feats, train=True, generators=gens)
    assert logits.shape == (g.n_nodes, 2, 3)
    y = torch.as_tensor(np.asarray(g.y) % 2, dtype=torch.int64)
    torch.nn.functional.cross_entropy(logits[:, 1], y).backward()
    assert not params[2].grad[1][:, 2].any() and not params[3].grad[1][2].any()
    assert params[2].grad[1][:, :2].any()


def test_ep_trainers_can_refit(ragged_corpus):
    g, child, parent = ragged_corpus
    ep = train_per_label(g, child, parent, _factory(), epochs=5, seed=3, ep=True,
                         trainer_kwargs=CPU)
    seq = train_per_label(g, child, parent, _factory(), epochs=5, seed=3,
                          trainer_kwargs=CPU)
    t, ts = ep["trainers"][0], seq["trainers"][0]
    state, state_s = t.optimizer.state_dict()["state"], ts.optimizer.state_dict()["state"]
    assert state.keys() == state_s.keys()
    for j in state:
        for k in state[j]:
            np.testing.assert_allclose(np.asarray(state[j][k]), np.asarray(state_s[j][k]),
                                       **TOL)
    # refit member 0 on its own label space: it continues, it does not crash
    sel = parent == 0
    local = np.zeros_like(child)
    local[sel] = np.searchsorted(np.unique(child[sel]), child[sel])
    y_local = np.zeros(g.n_nodes, np.int32)
    y_local[g.n_vocab:] = local
    hist = t.fit(dataclasses.replace(g, y=y_local), epochs=3, n_classes=len(ep["mapping"][0]))
    assert len(hist) == 3 and np.isfinite([r["loss"] for r in hist]).all()


def test_a_one_device_mesh_takes_the_batched_step(ragged_corpus):
    g, child, parent = ragged_corpus
    out = train_per_label(g, child, parent, _factory(), epochs=2, seed=3, mesh=1,
                          trainer_kwargs=CPU)
    assert len(out["trainers"]) == 2
    # more devices than one: the ranks of a parallel.Mesh, one process each
    # (tests/test_torch_multihost.py), not a count in this process
    with pytest.raises(ValueError, match="parallel.Mesh"):
        train_per_label(g, child, parent, _factory(), epochs=2, seed=3, mesh=2,
                        trainer_kwargs=CPU)


def test_the_members_hold_the_ensembles_operator(ragged_corpus):
    """The ensemble builds one operator through its lead trainer's
    aggregation, and every member adopts it with the features; a member's
    prepare keeps it for a graph of the same edges."""
    g, child, parent = ragged_corpus
    ens = Ensemble(g, child, parent, _factory(), trainer_kwargs=CPU)
    assert all(t._adj is ens.adj and t._feats is ens.feats for t in ens.trainers)
    assert len({t.aggregation for t in ens.trainers}) == 1
    relabelled = dataclasses.replace(g, y=np.zeros_like(g.y))
    assert ens.trainers[1].prepare(relabelled)[0] is ens.adj


@pytest.mark.parametrize("setting", [
    dict(use_pallas=False), dict(pallas_dtype="bfloat16"), dict(hybrid_k=16),
    dict(hybrid_k=16, hybrid_fused=True, hybrid_f32_mode="highest"), dict(plan_cache="plans"),
    dict(mesh=Mesh(None, 0, 1, torch.device("cpu"))),
    dict(tp_mesh=Mesh(None, 0, 1, torch.device("cpu"), axis="model")),
], ids=["segment", "bf16", "hybrid", "hybrid-fused-highest", "plan-cache", "mesh", "tp-mesh"])
def test_share_adjacency_adopts_nothing_across_settings(ragged_corpus, setting):
    g = ragged_corpus[0]
    make = _factory()
    donor = Trainer(make(g.in_dim, 3), **CPU)
    donor.prepare(g)
    other = Trainer(make(g.in_dim, 3), **CPU, **setting)
    other.share_adjacency(donor)
    assert other._adj is None and other._adj_key is None
    same = Trainer(make(g.in_dim, 3), **CPU)
    same.share_adjacency(donor)
    assert same._adj is donor._adj and same.aggregation == donor.aggregation


# ---- EGCN and JK members (tolerance as above; the LSTM against torch.nn.LSTM
# at 1e-5 relative, TF32 off on the CPU by construction)

def _model_factory(name, dropout=0.5, seed=0):
    from pytextgcn_tpu_torch.models import EGCN, JumpingKnowledgeNetwork

    gen = torch.Generator().manual_seed(seed)
    if name == "egcn":
        return lambda d_in, d_out: EGCN(d_in, d_out, embedding_dim=24, n_hidden_gcn=16,
                                        dropout=dropout, generator=gen)
    return lambda d_in, d_out: JumpingKnowledgeNetwork(d_in, d_out, n_hidden_gcn=16,
                                                       dropout=dropout, generator=gen)


def _assert_members_close_but_att_bias(a, b):
    """Every parameter but the JK network's attention bias, whose gradient
    is analytically zero (a softmax over the layers does not see a shift):
    Adam normalizes its rounding noise into full steps, which move it
    arbitrarily and the model's function not at all; the losses and
    predictions the callers compare cover it. That noise also reaches the
    LSTM's entries with near-zero gradients, so each parameter is held
    within 2e-4 of its largest magnitude (test_torch_models.py's rule)."""
    for ta, tb in zip(a, b):
        for (name, pa), pb in zip(ta.model.named_parameters(), tb.model.parameters()):
            if name != "att.b":
                want = pb.detach().numpy()
                np.testing.assert_allclose(pa.detach().numpy(), want, rtol=0,
                                           atol=2e-4 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("name", ["egcn", "jk"])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_ep_matches_sequential_egcn_and_jk(ragged_corpus, name, dropout):
    """The stacked EGCN (its embedding ``[in, M, 24]``, its dropout on the
    padded logits drawn in each member's own shape) and JK network (the
    batched LSTM) give the sequential members' parameters and losses."""
    g, child, parent = ragged_corpus
    seq = train_per_label(g, child, parent, _model_factory(name, dropout), epochs=15, seed=3,
                          trainer_kwargs=CPU)
    ep = train_per_label(g, child, parent, _model_factory(name, dropout), epochs=15, seed=3,
                         ep=True, trainer_kwargs=CPU)
    _assert_members_close_but_att_bias(seq["trainers"], ep["trainers"])
    for hs, he in zip(seq["histories"], ep["histories"]):
        np.testing.assert_allclose([r["loss"] for r in he], [r["loss"] for r in hs], **TOL)
    m_seq = eval_per_label(g, child, parent, seq["trainers"], seq["mapping"])
    m_ep = eval_per_label(g, child, parent, ep["trainers"], ep["mapping"])
    np.testing.assert_array_equal(m_ep["predictions"], m_seq["predictions"])


@pytest.mark.parametrize("name", ["egcn", "jk"])
def test_ep_egcn_and_jk_match_jax(ragged_corpus, name):
    """Shared initial parameters, dropout 0: EGCN against the JAX package's
    vmapped EP step on a one-device mesh; the JK network against the JAX
    package's sequential members, since its EP step pads and truncates
    ``layers[-1]``, which for the JK network is the last GCN layer and not
    the head (it returns that layer cut to the class count)."""
    from pytextgcn_tpu.models import EGCN as JaxEGCN
    from pytextgcn_tpu.models import JumpingKnowledgeNetwork as JaxJK

    g, child, parent = ragged_corpus
    ep = train_per_label(g, child, parent, _model_factory(name, 0.0, seed=5), epochs=12,
                         seed=3, ep=True, trainer_kwargs=CPU)
    fresh = _model_factory(name, 0.0, seed=5)
    inits = [export_params(fresh(g.in_dim, len(ep["mapping"][c]))) for c in range(2)]
    base = JaxEGCN if name == "egcn" else JaxJK
    kw = dict(embedding_dim=24) if name == "egcn" else {}
    made = []

    class _Fixed(base):
        def init(self, key):
            return jax.tree.map(jnp.asarray, self.params)

    def jax_factory(d_in, d_out):
        model = _Fixed(d_in, d_out, n_hidden_gcn=16, dropout=0.0, **kw)
        model.params = inits[len(made)]
        made.append(model)
        return model

    mesh = make_mesh(1, axis="ensemble") if name == "egcn" else None
    jep = jax_train_per_label(g, child, parent, jax_factory, epochs=12, seed=3, mesh=mesh)
    for t, jt in zip(ep["trainers"], jep["trainers"]):
        ours, theirs = export_params(t.model), jax.tree.map(np.asarray, jt.params)
        if name == "jk":  # see _assert_members_close_but_att_bias
            ours["att"].pop("b"), theirs["att"].pop("b")
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, b, rtol=0, atol=2e-4 * np.abs(b).max())


@pytest.mark.parametrize("t_len", [1, 2, 3])
def test_stacked_bilstm_matches_torch_lstm(t_len):
    from pytextgcn_tpu_torch.models.layers import bilstm, stacked_bilstm

    gen = torch.Generator().manual_seed(t_len)
    lstms = [bilstm(12, 10, gen) for _ in range(3)]
    x = torch.randn(3, 40, t_len, 12, generator=gen, requires_grad=True)
    x_ref = x.detach().clone().requires_grad_(True)
    want = torch.stack([m(x_ref[i])[0] for i, m in enumerate(lstms)])
    names = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
    stacked = {sfx: [torch.stack([getattr(m, n + sfx) for m in lstms]).detach()
                     .requires_grad_(True) for n in names] for sfx in ("", "_reverse")}
    got = stacked_bilstm(x, stacked[""], stacked["_reverse"])
    np.testing.assert_allclose(got.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    ct = torch.randn(got.shape, generator=gen)
    (got * ct).sum().backward()
    (want * ct).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), x_ref.grad.numpy(), rtol=1e-5, atol=1e-6)
    for sfx in ("", "_reverse"):
        for n, p in zip(names, stacked[sfx]):
            ref = torch.stack([getattr(m, n + sfx).grad for m in lstms])
            # one step reads no recurrent weight: no gradient, torch's is zero
            got = p.grad if p.grad is not None else torch.zeros_like(p)
            np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)
