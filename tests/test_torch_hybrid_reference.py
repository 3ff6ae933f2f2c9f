"""The port's flat GCN on the hybrid aggregation (``ops/hybrid.py``, the
configuration ``benchmark/configs/textgcn-amazon-hybrid.json``) against the
benchmark's plain reference (``benchmark/reference/train.py``: float64, the
undecomposed sparse ``A_hat``, Adam written out), at a small size on the
CPU, where the dual product runs its plain version
(``ops/fused_dual.py::dual_reference``: the split's three bf16 products
summed in float32, as the kernel computes them).

The port's ``Trainer`` takes the configuration's ``trainer`` settings whole,
K cut to 64 of the graph's ~1,500 nodes, and starts from the benchmark's
initial parameters (``benchmark/weights.py``) and the same dropout seed. The
comparison fails with the split's lo plane zeroed (D as one bf16 plane) and
with ``a_hh`` zeroed (the hot-hot block counted twice).
"""

import json
import os
import sys
from unittest import mock

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import weights  # noqa: E402
from benchmark.reference import graph as ref_graph  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402
from pytextgcn_tpu_torch import Text2Graph  # noqa: E402
from pytextgcn_tpu_torch.config import ModelConfig, make_model  # noqa: E402
from pytextgcn_tpu_torch.data import synthetic_corpus  # noqa: E402
from pytextgcn_tpu_torch.ops import hybrid  # noqa: E402
from pytextgcn_tpu_torch.train import Trainer  # noqa: E402

CPU = torch.device("cpu")
CONFIG = json.load(open(os.path.join(ROOT, "benchmark", "configs",
                                     "textgcn-amazon-hybrid.json")))
HOT_K = 64
SEED = 2 ** 31 + 23
STEPS = 3
# float32 with the split's ~2^-17 relative products against float64, each
# gap against the larger of the reference value and the median one (losses
# against the value): losses read 7e-8 here, first gradient norms and each
# leaf's change over three AMSGrad steps 4.5e-8. The limit is fourteen times
# the largest; D as its bf16 hi plane alone reads 4.4e-6 to 1e-5, a zeroed
# a_hh 7e-5 or more.
LOSS_TOL, GRAD_TOL, UPDATE_TOL = 1e-6, 1e-6, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    docs, labels = synthetic_corpus(n_docs=1200, n_classes=8, seed=31)
    rng = np.random.default_rng(4)
    test_idx = rng.choice(len(docs), 240, replace=False)
    val_idx = np.setdiff1d(rng.choice(len(docs), 120, replace=False), test_idx)
    g = Text2Graph(min_df=1, window_size=5).fit_transform(docs, labels, test_idx=test_idx,
                                                          val_idx=val_idx)
    graph = dict(src=np.asarray(g.edge_src), dst=np.asarray(g.edge_dst),
                 w=np.asarray(g.edge_w), n_vocab=g.n_vocab, n_docs=g.n_docs)
    graph["norm_w"], graph["self_w"] = ref_graph.normalize(graph)
    return g, graph, 8


def program(corpus):
    """The port's side: the configuration's model and trainer at K = 64,
    three epochs of ``fit``; each epoch's losses, the first step's gradient
    norm per leaf and each leaf's change over the three steps."""
    g, _, n_classes = corpus
    model_cfg = dict(CONFIG["model"])
    model = make_model(ModelConfig(model=model_cfg.pop("kind"), **model_cfg), g.in_dim,
                       n_classes, torch.Generator().manual_seed(SEED))
    init = weights.initial_params(CONFIG["model"], g.n_nodes, n_classes, SEED, CPU)
    named = dict(model.named_parameters())
    with torch.no_grad():
        for k, v in init.items():
            named[k].copy_(v)
    trainer = Trainer(model, seed=SEED, device=CPU,
                      **dict(CONFIG["trainer"], hybrid_k=HOT_K))
    adj, _ = trainer.prepare(g)
    assert isinstance(adj.plan, hybrid.HybridPlan) and adj.plan.k == HOT_K
    assert adj.plan.d_lo is not None and adj.plan.res is not None
    grad1 = {}

    def hook(k):
        def norm(p):
            grad1.setdefault(k, float(p.grad.double().norm()))
        return norm

    hooks = [p.register_post_accumulate_grad_hook(hook(k)) for k, p in named.items()]
    hist = trainer.fit(g, epochs=1, n_classes=n_classes)
    for h in hooks:
        h.remove()
    hist += trainer.fit(g, epochs=STEPS - 1, n_classes=n_classes)
    delta = {k: float((p.detach().double() - init[k].double()).norm())
             for k, p in named.items()}
    return {"loss": [h["loss"] for h in hist], "val_loss": [h["val_loss"] for h in hist],
            "grad1": grad1, "delta": delta}, init


def reference(corpus, init):
    g, graph, n_classes = corpus
    a, a_t = ref_train.sparse_ahat(graph["src"], graph["dst"], graph["norm_w"],
                                   graph["self_w"], torch.float64, CPU)
    y = torch.as_tensor(np.asarray(g.y))
    m = ref_train.Model(weights.model_kind(CONFIG["model"]), CONFIG["model"], a, a_t, y,
                        "float64")
    gen = torch.Generator().manual_seed(ref_train.dropout_seed(SEED))
    adam = dict(CONFIG["adam"], lr=CONFIG["trainer"]["lr"])
    return ref_train.train_steps(m, adam, init, torch.as_tensor(np.asarray(g.train_mask)),
                                 torch.as_tensor(np.asarray(g.val_mask)), gen, STEPS)


def leaf_gap(got: dict, want: dict) -> float:
    assert got.keys() == want.keys()
    med = np.median(list(want.values()))
    return max(abs(got[k] - want[k]) / max(want[k], med) for k in want)


def gaps(corpus) -> dict:
    prog, init = program(corpus)
    want = reference(corpus, init)
    loss = np.array(prog["loss"] + prog["val_loss"])
    ref_loss = np.array(want["loss"] + want["val_loss"])
    return {"loss": float(np.max(np.abs(loss - ref_loss) / ref_loss)),
            "grad": leaf_gap(prog["grad1"], want["grad1"]),
            "update": leaf_gap(prog["delta"], want["delta"])}


def within(g: dict) -> dict:
    return {"loss": g["loss"] < LOSS_TOL, "grad": g["grad"] < GRAD_TOL,
            "update": g["update"] < UPDATE_TOL}


def test_three_steps_match_the_reference(corpus):
    g = gaps(corpus)
    assert all(within(g).values()), g


def hi_plane_alone():
    """D held as the bf16 hi plane alone: the split's lo plane zeroed, so
    each product is one bf16 pass over D."""
    orig = hybrid.split_bf16

    def split_bf16(a):
        hi, lo = orig(a)
        return hi, torch.zeros_like(lo)

    return mock.patch.object(hybrid, "split_bf16", split_bf16)


def hot_hot_counted_twice():
    """``a_hh`` zeroed: the hot-hot block is left in both the hot rows' and
    the hot columns' products."""
    orig = hybrid.dense_blocks

    def dense_blocks(*a, **k):
        d_full, d_lo, a_hh = orig(*a, **k)
        return d_full, d_lo, torch.zeros_like(a_hh)

    return mock.patch.object(hybrid, "dense_blocks", dense_blocks)


@pytest.mark.parametrize("fault", [hi_plane_alone, hot_hot_counted_twice])
def test_a_planted_fault_fails_the_comparison(corpus, fault):
    with fault():
        g = gaps(corpus)
    assert not all(within(g).values()), g
