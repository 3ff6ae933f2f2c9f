"""The plain reference against hand derivations at a tiny size."""

import math

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import graph as rg
from benchmark.reference import train as rt

CPU = torch.device("cpu")
GRAPH = {"min_df": 1, "max_df": 1.0, "window_size": 2, "max_length": None,
         "rm_stopwords": False}


def edges(g):
    return {(int(s), int(d)): float(w) for s, d, w in zip(g["src"], g["dst"], g["w"])}


def test_graph_by_hand():
    docs = ["aa bb aa", "BB cc", "aa cc dd x"]  # "x" is one character: no term
    g = rg.build_graph(docs, [0, 1, 0], [2], [1], GRAPH, CPU)
    assert (g["n_vocab"], g["n_docs"]) == (4, 3)  # aa bb cc dd
    e = edges(g)
    # windows of 2: doc 0 has 2, doc 1 one, doc 2 two (x is not in the
    # vocabulary); c_aa = 3, c_bb = 3, c_cc = 3, c_dd = 1, c_ab = 2, c_cd = 1
    assert e[(0, 1)] == e[(1, 0)] == pytest.approx(math.log((2 / 5) / (3 / 5 * 3 / 5)))
    assert e[(2, 3)] == pytest.approx(math.log((1 / 5) / (3 / 5 * 1 / 5)))
    assert (1, 2) not in e and (0, 2) not in e  # negative PMI is dropped
    # doc 0: tf aa 2, bb 1, equal idf: 2 / sqrt(5), 1 / sqrt(5), both ways
    assert e[(4, 0)] == e[(0, 4)] == pytest.approx(2 / math.sqrt(5))
    assert e[(4, 1)] == pytest.approx(1 / math.sqrt(5))
    # doc 2: aa and cc (df 2), dd (df 1): idf ln(4/3) + 1 and ln(2) + 1
    i2, i1 = math.log(4 / 3) + 1, math.log(2) + 1
    assert e[(6, 3)] == pytest.approx(i1 / math.sqrt(2 * i2 ** 2 + i1 ** 2))
    assert len(e) == 4 + 2 * 7
    assert list(np.flatnonzero(g["train_mask"])) == [4]
    assert list(np.flatnonzero(g["val_mask"])) == [5]
    assert list(np.flatnonzero(g["test_mask"])) == [6]


def test_document_frequency_bounds():
    docs = ["aa bb", "aa cc", "aa dd", "bb cc"]
    g = rg.build_graph(docs, [0] * 4, [], [], dict(GRAPH, min_df=2, max_df=0.7), CPU)
    assert g["n_vocab"] == 2  # aa in 4 of 4 docs > int(0.7 * 4); dd in 1 < 2


def windows_by_enumeration(ids, lens, w, v):
    """The reference system's loop (graphbuilder.pyx:71-115) written out."""
    counts, n_windows, off = {}, 0, 0
    for n in lens:
        doc = list(ids[off:off + n]) + [-1] * max(0, w - n)
        off += n
        for j in range(len(doc) - w + 1):
            if doc[j + w - 1] == -1 and j != 0:
                break
            n_windows += 1
            for k in range(j, j + w):
                if doc[k] == -1:
                    break
                for l in range(k, j + w):
                    if doc[l] == -1:
                        break
                    key = (min(doc[k], doc[l]), max(doc[k], doc[l]))
                    counts[key] = counts.get(key, 0) + 1
    return counts, n_windows


@pytest.mark.parametrize("w", [1, 2, 3, 5])
def test_pair_counts_equal_the_window_loop(w):
    rng = np.random.default_rng(w)
    lens = rng.integers(0, 9, 12)
    ids = rng.integers(0, 6, int(lens.sum()))
    a, b, c, n_windows = rg._pair_counts(ids, lens, w, 6, CPU)
    want, want_windows = windows_by_enumeration(ids, lens, w, 6)
    assert n_windows == want_windows
    assert dict(zip(zip(a.tolist(), b.tolist()), c.tolist())) == want


def test_normalize_by_hand():
    g = {"src": np.array([0, 1]), "dst": np.array([1, 0]), "w": np.array([2.0, 2.0], np.float32),
         "n_vocab": 1, "n_docs": 2}
    norm_w, self_w = rg.normalize(g)
    # degrees 3, 3, 1
    assert np.allclose(norm_w, [2 / 3, 2 / 3]) and np.allclose(self_w, [1 / 3, 1 / 3, 1])


def test_tf32_round():
    x = torch.tensor([1 + 2 ** -10, 1 + 2 ** -11, 1 + 3 * 2 ** -11, -3.0, 0.0])
    assert rt.tf32_round(x).tolist() == [1 + 2 ** -10, 1.0, 1 + 2 ** -9, -3.0, 0.0]


@pytest.mark.parametrize("kind", ["gcn", "egcn"])
def test_train_steps_against_autograd_and_torch_adam(kind):
    """Dropout 0: the reference's three steps equal a dense autograd model
    trained by torch.optim.Adam(amsgrad=True) itself."""
    n, c = 7, 3
    rng = np.random.default_rng(0)
    src = np.array([0, 1, 2, 3, 4, 5, 6, 1])
    dst = np.array([1, 0, 3, 2, 5, 6, 4, 6])
    w = rng.random(8)
    self_w = rng.random(n)
    a, a_t = rt.sparse_ahat(src, dst, w, self_w, torch.float64, CPU)
    dense = torch.zeros(n, n, dtype=torch.float64)
    dense[dst, src] += torch.as_tensor(w)
    dense += torch.diag(torch.as_tensor(self_w))
    model = {"kind": kind, "n_gcn": 2, "dropout": 0.0}
    gen = torch.Generator().manual_seed(1)
    params = {"layers.0.w": torch.randn(n if kind == "gcn" else 4, 5, generator=gen),
              "layers.0.b": torch.randn(5, generator=gen),
              "layers.1.w": torch.randn(5, c, generator=gen),
              "layers.1.b": torch.randn(c, generator=gen)}
    if kind == "egcn":
        params.update({"embed.w": torch.randn(n, 4, generator=gen),
                       "embed.b": torch.randn(4, generator=gen)})
    y = torch.tensor([0, 1, 2, 0, 1, 2, 0])
    tm = torch.tensor([False, True, True, False, True, True, True])
    vm = ~tm
    adam = {"lr": 0.05, "betas": [0.9, 0.999], "eps": 1e-8, "amsgrad": True}
    m = rt.Model(weights.model_kind(model), model, a, a_t, y, "float64")
    out = rt.train_steps(m, adam, params, tm, vm, torch.Generator().manual_seed(3), steps=3)

    p = {k: v.double().clone().requires_grad_(True) for k, v in params.items()}
    opt = torch.optim.Adam(list(p.values()), lr=0.05, amsgrad=True)

    def logits():
        h = p["layers.0.w"]
        if kind == "egcn":
            h = torch.selu(p["embed.w"] + p["embed.b"]) @ p["layers.0.w"]
        h = dense @ h + p["layers.0.b"]
        return dense @ (h @ p["layers.1.w"]) + p["layers.1.b"]

    ce = lambda z, m: torch.nn.functional.cross_entropy(z[m], y[m])
    for t in range(3):
        opt.zero_grad()
        loss = ce(logits(), tm)
        loss.backward()
        if t == 0:
            assert out["grad1"] == pytest.approx({k: float(v.grad.norm()) for k, v in p.items()},
                                                 rel=1e-10)
        opt.step()
        assert out["loss"][t] == pytest.approx(loss.item(), rel=1e-12)
        with torch.no_grad():
            assert out["val_loss"][t] == pytest.approx(float(ce(logits(), vm)), rel=1e-12)
    assert out["delta"] == pytest.approx(
        {k: float((v.detach() - params[k].double()).norm()) for k, v in p.items()}, rel=1e-10)


def test_dropout_draws_the_trainers_stream():
    """The reference's masks are torch.rand(shape) < keep from a generator
    seeded by the trainer's rule, in the forward pass's order."""
    seed = 2 ** 31 + 11
    gen = torch.Generator().manual_seed(rt.dropout_seed(seed))
    assert rt.dropout_seed(seed) < 2 ** 63
    first = torch.rand((4, 3), generator=gen)
    again = torch.rand((4, 3), generator=torch.Generator().manual_seed(rt.dropout_seed(seed)))
    assert torch.equal(first, again)


@pytest.mark.parametrize("kind", ["gcn", "egcn"])
def test_one_step_is_the_first_of_the_steps(kind):
    """With dropout on: a step from the same parameters and generator state
    draws the same masks and gives the same loss and gradients as the first
    of ``train_steps``, and the validation loss before it."""
    n, c = 6, 3
    rng = np.random.default_rng(1)
    src, dst = np.array([0, 1, 2, 3, 4, 5]), np.array([1, 2, 3, 4, 5, 0])
    a, a_t = rt.sparse_ahat(src, dst, rng.random(6), rng.random(n), torch.float64, CPU)
    model = {"kind": kind, "n_gcn": 2, "n_hidden": 4, "dropout": 0.5, "embedding_dim": 5}
    params = weights.initial_params(model, n, c, 7, CPU)
    y = torch.tensor([0, 1, 2, 0, 1, 2])
    tm = torch.tensor([True, True, True, True, False, False])
    m = rt.Model(weights.model_kind(model), model, a, a_t, y, "float64")
    adam = {"lr": 0.05, "betas": [0.9, 0.999], "eps": 1e-8, "amsgrad": True}
    gen = torch.Generator().manual_seed(rt.dropout_seed(7))
    state = gen.get_state()
    steps = rt.train_steps(m, adam, params, tm, ~tm, gen, steps=1)
    gen.set_state(state)
    step = rt.one_step(m, params, tm, ~tm, gen)
    assert step["loss"] == steps["loss"][0]
    assert step["grad"] == steps["grad1"]
    with torch.no_grad():
        assert step["val_loss"] == float(m.loss(m.params(params), ~tm, None))
