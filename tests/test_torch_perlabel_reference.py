"""The port's batched per-label ensemble (``hierarchy/perlabel.py::Ensemble``)
against the benchmark's plain per-member reference
(``benchmark/reference/perlabel.py``: each member its own float64 GCN, plain
Adam, its own dropout generator), at a small size on the CPU.

Four parents with 1, 2, 4 and 3 children: a member of one class (a loss of 0,
no gradient), padding to 4 classes for the others. Both sides start from the
benchmark's initial parameters and dropout seeds
(``benchmark/models/perlabel.py``). Tolerances: float32 against float64 on
one graph, where the stacked products and reductions also sum in other
orders; each below is ten times or more what this size reads.
"""

import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.models import perlabel as counts  # noqa: E402
from benchmark.reference import graph as ref_graph  # noqa: E402
from benchmark.reference import perlabel as ref  # noqa: E402
from pytextgcn_tpu_torch import Text2Graph  # noqa: E402
from pytextgcn_tpu_torch.data import synthetic_corpus  # noqa: E402
from pytextgcn_tpu_torch.hierarchy import eval_per_label  # noqa: E402
from pytextgcn_tpu_torch.hierarchy.perlabel import Ensemble  # noqa: E402
from pytextgcn_tpu_torch.models import GCN  # noqa: E402

CPU = torch.device("cpu")
PARENT_OF = np.array([0, 1, 1, 2, 2, 2, 2, 3, 3, 3])  # 1, 2, 4 and 3 children
ADAM = {"lr": 0.05, "betas": [0.9, 0.999], "eps": 1e-8, "amsgrad": False}
SEED = 2 ** 31 + 19
# float32 against float64, each gap against the larger of the reference
# value and the median one: losses and routed logits read 1e-7 and 4e-7 here,
# gradient norms 1.4e-7, each leaf's change over three Adam steps 7e-8
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 4e-6, 2e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    docs, child = synthetic_corpus(n_docs=320, n_classes=10, seed=29)
    child = np.asarray(child)
    parent = PARENT_OF[child]
    rng = np.random.default_rng(3)
    test_idx = rng.choice(len(docs), 64, replace=False)
    val_idx = np.setdiff1d(rng.choice(len(docs), 32, replace=False), test_idx)
    g = Text2Graph(min_df=1, window_size=5).fit_transform(docs, child, test_idx=test_idx,
                                                          val_idx=val_idx)
    graph = dict(src=np.asarray(g.edge_src), dst=np.asarray(g.edge_dst),
                 w=np.asarray(g.edge_w), n_vocab=g.n_vocab, n_docs=g.n_docs,
                 train_mask=np.asarray(g.train_mask), val_mask=np.asarray(g.val_mask),
                 test_mask=np.asarray(g.test_mask))
    graph["norm_w"], graph["self_w"] = ref_graph.normalize(graph)
    return g, graph, child, parent


def model(dropout):
    return {"kind": "gcn", "n_gcn": 2, "n_hidden": 16, "dropout": dropout}


def ensemble(corpus, dropout, seed=SEED):
    """The port's ensemble from the benchmark's initial parameters and
    dropout seeds; returns it with those parameters."""
    g, _, child, parent = corpus
    c_list = counts.member_classes(child, parent)
    init = counts.initial_params(model(dropout), g.n_nodes, c_list, seed, CPU)
    todo = iter(init)

    def make(d_in, d_out):
        m = GCN(d_in, d_out, n_hidden_gcn=16, dropout=dropout)
        values = next(todo)
        with torch.no_grad():
            for name, p in m.named_parameters():
                p.copy_(values[name])
        return m

    ens = Ensemble(g, child, parent, make, lr=ADAM["lr"], seed=seed,
                   trainer_kwargs={"device": "cpu"})
    for i, gen in enumerate(ens.generators):
        gen.manual_seed(counts.member_dropout_seed(seed, i))
    return ens, init


def reference(corpus, dropout):
    _, graph, child, parent = corpus
    return ref.Ensemble(model(dropout), graph, child, parent, CPU)


def gens(n, seed=SEED):
    return [torch.Generator().manual_seed(counts.member_dropout_seed(seed, i)) for i in range(n)]


def scaled_gap(x, want):
    x, want = np.asarray(x, np.float64).ravel(), np.asarray(want, np.float64).ravel()
    scale = np.maximum(np.abs(want), np.median(np.abs(want)))
    return float(np.max(np.abs(x - want) / scale))


def leaf_gap(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    med = np.median(list(want.values()))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in want)


def norms(views):
    return {f"m{i}.{k}": float(v.detach().double().norm()) for i, d in enumerate(views)
            for k, v in d.items()}


def test_members_and_class_counts(corpus):
    g, _, child, parent = corpus
    ens, _ = ensemble(corpus, 0.0)
    assert ens.c_list == [1, 2, 4, 3] == counts.member_classes(child, parent)
    assert [m["classes"].tolist() for m in ref.members(child, parent, g.n_vocab)] == [
        ens.mapping[c] for c in range(4)]
    # the stacked head is padded to 4 classes; each member's view is its own
    views = ens.member_params()
    assert [tuple(v["layers.1.w"].shape) for v in views] == [(16, c) for c in ens.c_list]


@pytest.mark.parametrize("dropout", [0.0, 0.7])
def test_three_steps_match_the_reference(corpus, dropout):
    """Each member's losses, first gradient norms and change over three
    steps."""
    g = corpus[0]
    ens, init = ensemble(corpus, dropout)
    rows = ens.fit(1)
    grad1 = norms(ens.member_params([q.grad for q in ens.params]))
    rows += ens.fit(2)
    delta = {f"m{i}.{k}": float((v.detach().double() - init[i][k].double()).norm())
             for i, d in enumerate(ens.member_params()) for k, v in d.items()}
    want = reference(corpus, dropout).train_steps(ADAM, init, gens(4), 3)
    assert scaled_gap(rows, want["loss"]) < LOSS_TOL
    assert leaf_gap(grad1, want["grad1"]) < GRAD_TOL
    moving = [k for k, v in want["grad1"].items() if v > 0]
    assert leaf_gap({k: delta[k] for k in moving}, {k: want["delta"][k] for k in moving}) \
        < UPDATE_TOL
    # the one-class member: a loss of 0 and no gradient, on both sides
    assert [r[0] for r in rows] == [0.0] * 3 and grad1["m0.layers.0.w"] == 0.0
    assert g.n_nodes == len(corpus[1]["self_w"])


def test_one_step_from_copied_state_and_generators(corpus):
    ens, _ = ensemble(corpus, 0.7)
    ens.fit(2)
    params = [{k: v.detach().clone() for k, v in d.items()} for d in ens.member_params()]
    states = [gen.get_state() for gen in ens.generators]
    loss = ens.fit(1)[0]
    grad = norms(ens.member_params([q.grad for q in ens.params]))
    ref_gens = gens(4)
    for gen, st in zip(ref_gens, states):
        gen.set_state(st)
    want = reference(corpus, 0.7).one_step(params, ref_gens)
    assert scaled_gap(loss, want["loss"]) < LOSS_TOL
    assert leaf_gap(grad, want["grad"]) < GRAD_TOL


def test_fit_resumed_in_two_calls_equals_one_call_bit_for_bit(corpus):
    one, _ = ensemble(corpus, 0.7)
    two, _ = ensemble(corpus, 0.7)
    rows = one.fit(5)
    assert two.fit(2) + two.fit(3) == rows
    assert one.epoch == two.epoch == 5
    for a, b in zip(one.params, two.params):
        assert torch.equal(a, b)
    for a, b in zip(one.generators, two.generators):
        assert torch.equal(a.get_state(), b.get_state())


def test_fit_reads_once_an_epoch_only_with_a_log_fn(corpus):
    ens, _ = ensemble(corpus, 0.7)
    lines = []
    rows = ens.fit(3, lines.append)
    assert [line.split("]")[0] for line in lines] == ["[1", "[2", "[3"]
    assert all(line.startswith("[") and line.count(",") == 3 for line in lines)
    assert [len(r) for r in rows] == [4, 4, 4]
    quiet, _ = ensemble(corpus, 0.7)
    assert quiet.fit(3) == rows


def test_composed_routed_logits_match_the_reference(corpus):
    """Ground-truth routing (eval_per_label's default): each test document's
    logits from its parent's member, read from the ensemble's own state and,
    after ``finish``, from the members' Trainers restacked."""
    g, graph, child, parent = corpus
    ens, _ = ensemble(corpus, 0.7)
    rows = ens.fit(4)
    out = eval_per_label(g, child, parent, ens, ens.mapping)
    test_docs = np.asarray(g.test_mask)[g.n_vocab:]
    got = torch.cat([out["logits"][torch.as_tensor(np.flatnonzero(test_docs & (parent == c))),
                                   c, :n].reshape(-1) for c, n in enumerate(ens.c_list)])
    want = reference(corpus, 0.7).routed_logits(ens.member_params())
    assert scaled_gap(got.numpy(), want) < LOSS_TOL
    # padded columns never win; the members' Trainers give the same predictions
    assert torch.isinf(out["logits"][:, 0, 1:]).all()
    members = ens.finish(rows)
    again = eval_per_label(g, child, parent, members["trainers"], members["mapping"])
    np.testing.assert_array_equal(again["predictions"], out["predictions"])
    assert again["accuracy"] == out["accuracy"]
