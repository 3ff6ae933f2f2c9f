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
from pytextgcn_tpu_torch.hierarchy.perlabel import (_PAD_BIAS, _batched_member_preds,
                                                    _stack_members, _stacked_logits)
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj

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
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        train_per_label(g, child, parent, _factory(), epochs=2, seed=3, mesh=2,
                        trainer_kwargs=CPU)
