"""EGCN's embedding activation as one pass each way (``ops/embedding.py``,
``csrc/embedding.cu``).

The card tests' oracle is here: the eager composition
``dropout(torch.selu(W + b))`` over given uniforms (:func:`forward_reference`),
its gradient as autograd forms it (:func:`backward_reference`), and the
kernel's bit-packed keep mask (:func:`pack`, :func:`unpack`).

On the CPU: the mask's packing, the dispatch (only a card's identity-feature
EGCN without a tensor-parallel layout or a halo takes the fused pass, and
EGCN hands it its embedding's weight, bias, rate, mode and generator), and
that :class:`SeluDropout` refuses CPU tensors.

The tests marked ``gpu`` skip without a card. They hold the kernels against
the eager composition bit for bit at EGCN's shape, dropout 0.7 and 0, a width
that is not a multiple of 4, NaN and inf in W, and count the launches of a
graphed fit. On the card (no JAX there, so tests/conftest.py is skipped and
the marker registered on the command line):
``python -m pytest --noconftest -o "markers=gpu: needs a CUDA device"
tests/test_torch_embedding.py -q``.
"""

import math

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.config import ModelConfig, make_model
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.models.layers import dropout
from pytextgcn_tpu_torch.ops import embedding
from pytextgcn_tpu_torch.ops.embedding import SeluDropout
from pytextgcn_tpu_torch.ops.features import NodeFeatures
from pytextgcn_tpu_torch.train import Trainer

CPU = torch.device("cpu")

# ATen/native/Activation.cpp's SELU_ALPHA and SELU_SCALE: torch.selu is elu
# with them, and its backward elu_backward
_ALPHA = 1.6732632423543772848170429916717
_SCALE = 1.0507009873554804934193349852946


def pack(keep: torch.Tensor) -> torch.Tensor:
    """The kernel's mask of the bool ``keep`` (any shape, read flat) as
    int32 words: for each group of 32 vectors of 4 elements, word k's bit l
    is element k of vector l; then one word of the last ``n % 4``."""
    flat = keep.reshape(-1).long()
    n4, groups = flat.numel() // 4, embedding._words(flat.numel()) // 4
    vec = flat.new_zeros(groups * 128)
    vec[:4 * n4] = flat[:4 * n4]
    lanes = torch.arange(32, device=flat.device)
    words = (vec.view(groups, 32, 4).transpose(1, 2) << lanes).sum(-1).reshape(-1)
    tail = (flat[4 * n4:] << lanes[:flat.numel() - 4 * n4]).sum().reshape(1)
    words = torch.cat([words, tail])
    return (words - (words >= 2 ** 31).long() * 2 ** 32).to(torch.int32)


def unpack(words: torch.Tensor, shape) -> torch.Tensor:
    """The bool mask of ``shape`` that :func:`pack` gave ``words``."""
    n = math.prod(shape)
    n4, groups = n // 4, embedding._words(n) // 4
    w = words.long() & 0xFFFFFFFF
    lanes = torch.arange(32, device=w.device)
    bits = (w[:4 * groups].view(groups, 4, 1) >> lanes) & 1
    flat = bits.transpose(1, 2).reshape(-1)[:4 * n4]
    tail = (w[4 * groups] >> lanes[:n - 4 * n4]) & 1
    return torch.cat([flat, tail]).bool().view(shape)


def forward_reference(w, b, u, rate):
    """``(h, mask)``: ``selu(w + b)`` and, given uniforms ``u``, inverted
    dropout at ``rate`` with the keep mask ``u < 1 - rate`` (packed), as
    ``models/layers.py::dropout`` computes it."""
    h = torch.selu(w + b)
    if u is None:
        return h, None
    keep = 1.0 - rate
    m = u < keep
    return torch.where(m, h / keep, 0.0), pack(m)


def backward_reference(dh, w, b, mask, rate):
    """The gradient of :func:`forward_reference`'s ``h`` with respect to
    ``w``, as autograd forms it: where's and div's backward under the mask,
    then SELU's (``elu_backward``)."""
    g = dh if mask is None else torch.where(unpack(mask, dh.shape), dh, 0.0) / (1.0 - rate)
    return torch.ops.aten.elu_backward(g, _ALPHA, _SCALE, 1.0, False, w + b)


def _eager(w, b, rate, train, generator):
    """The composition EGCN runs without the fused pass (identity features:
    ``feats.matmul(w)`` is ``w[:N]``)."""
    return dropout(torch.selu(w[:w.shape[0]] + b), rate, train, generator)


def _both(shape, rate, train, device, seed=3, w=None, b=None):
    """Output, dW, db and the generator's state of the eager composition and
    of :func:`embedding.selu_dropout` on the same parameters, uniforms and
    upstream gradient."""
    gen = torch.Generator(device=device).manual_seed(seed)
    if w is None:
        w = torch.randn(shape, generator=gen, device=device)
    if b is None:
        b = torch.randn(shape[1], generator=gen, device=device)
    dh = torch.randn(shape, generator=gen, device=device)
    out = []
    for fn in (_eager, embedding.selu_dropout):
        wp, bp = w.clone().requires_grad_(), b.clone().requires_grad_()
        g = torch.Generator(device=device).manual_seed(seed + 1)
        h = fn(wp, bp, rate, train, g)
        dw, db = torch.autograd.grad(h, (wp, bp), dh)
        out.append((h.detach(), dw, db, g.get_state()))
    return out


def _same(a, b):
    """Equal bit for bit, NaN payloads aside (a NaN matches a NaN)."""
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    na, nb = torch.isnan(a), torch.isnan(b)
    return bool(torch.equal(na, nb) and torch.equal(
        torch.where(na, 0.0, a).view(torch.int32), torch.where(nb, 0.0, b).view(torch.int32)))


def _assert_same(eager, fused):
    for x, y, name in zip(eager, fused, ("h", "dW", "db", "generator")):
        assert _same(x, y) if x.is_floating_point() else torch.equal(x, y), name


# -------------------------------------------------------------- the CPU


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (5, 3), (37, 20), (300, 7), (33, 128)])
def test_packed_mask_round_trips(shape):
    keep = torch.rand(shape, generator=torch.Generator().manual_seed(1)) < 0.3
    words = pack(keep)
    n = keep.numel()
    assert words.dtype == torch.int32 and words.numel() == 4 * -(-(n // 4) // 32) + 1
    assert torch.equal(unpack(words, shape), keep)


def test_packed_mask_layout():
    """Word 4g + k, bit l: element k of vector 32g + l; the tail word holds
    the last n % 4 elements from bit 0."""
    n = 4 * 40 + 3  # two groups of vectors (the second of 8), a tail of 3
    for e in (0, 5, 4 * 33 + 2, 4 * 39 + 3, 160, 162):
        keep = torch.zeros(n, dtype=torch.bool)
        keep[e] = True
        words = pack(keep).long() & 0xFFFFFFFF
        want = torch.zeros(9, dtype=torch.long)
        if e < 160:
            want[4 * (e // 4 // 32) + e % 4] = 1 << (e // 4 % 32)
        else:
            want[8] = 1 << (e - 160)
        assert torch.equal(words, want), e


@pytest.mark.parametrize("u", [True, False])
def test_the_fused_pass_refuses_cpu_tensors(u):
    w = torch.zeros(6, 4, requires_grad=True)
    before = SeluDropout.launches
    with pytest.raises(ValueError, match="CUDA"):
        SeluDropout.apply(w, torch.zeros(4), torch.rand(6, 4) if u else None, 0.5)
    assert SeluDropout.launches == before


class _Card:
    """A stand-in for a CUDA weight: what :func:`embedding.takes` reads."""

    is_cuda = True

    def __init__(self, rows):
        self.shape = (rows, 8)


_FEATS = NodeFeatures(n_vocab=7, n_docs=5)
TAKES = {
    "card-identity": (_Card(12), _FEATS, None, None, True),
    "cpu": (torch.zeros(12, 8), _FEATS, None, None, False),
    "tensor-parallel": (_Card(12), _FEATS, object(), None, False),
    "halo": (_Card(12), _FEATS, None, (12, 6), False),
    "explicit-x": (_Card(12), NodeFeatures(7, 5, x=torch.zeros(12, 12)), None, None, False),
    "hierarchy": (_Card(14), NodeFeatures(7, 5, hierarchy=torch.zeros(5, 2)), None, None,
                  False),
    "subgraph": (_Card(12), _FEATS.subgraph(torch.arange(6)), None, None, False),
    "row-block": (_Card(12), _FEATS.row_block(0, 6), None, None, False),
    "wider-weight": (_Card(13), _FEATS, None, None, False),
}


@pytest.mark.parametrize("case", list(TAKES))
def test_only_a_cards_whole_identity_embedding_takes_the_fused_pass(case):
    w, feats, tp, rows, want = TAKES[case]
    assert embedding.takes(w, feats, tp, rows) is want


@pytest.fixture(scope="module")
def graph():
    docs, labels = synthetic_corpus(n_docs=60, n_classes=3, seed=5)
    rng = np.random.default_rng(2)
    test_idx = rng.choice(60, 12, replace=False)
    return Text2Graph(min_df=1, window_size=5).fit_transform(docs, labels, test_idx=test_idx)


def _egcn(g, dropout_rate=0.5):
    cfg = ModelConfig(model="egcn", n_hidden=8, dropout=dropout_rate, embedding_dim=10)
    return make_model(cfg, g.in_dim, 3, torch.Generator().manual_seed(7))


@pytest.mark.parametrize("train", [True, False])
def test_egcn_through_the_fused_pass_equals_the_eager_model(graph, train, monkeypatch):
    """EGCN with its embedding routed to :func:`embedding.selu_dropout`
    (forced on the CPU, the fused op stood in for by the eager composition
    over what it is handed) gives the eager model's logits and gradients
    bit for bit, and the dropout generator ends in the same state: EGCN
    hands over its embedding's weight and bias, its rate, the mode and the
    generator."""
    runs = []
    for fused in (False, True):
        calls, handed = [], []
        monkeypatch.setattr(embedding, "takes", lambda *a: calls.append(a) or fused)
        monkeypatch.setattr(embedding, "selu_dropout",
                            lambda *a: handed.append(a) or _eager(*a))
        model = _egcn(graph)
        adj, feats = Trainer(model, device=CPU).prepare(graph)
        gen = torch.Generator().manual_seed(9)
        logits = model(adj, feats, train=train, generator=gen)
        grads = torch.autograd.grad(logits.square().sum(), list(model.parameters()))
        assert len(calls) == 1 and calls[0][0] is model.embed.w and calls[0][1] is feats
        assert len(handed) == fused
        if fused:
            w, b, rate, mode, g = handed[0]
            assert (w is model.embed.w and b is model.embed.b and rate == model.dropout
                    and mode is train and g is gen)
        runs.append((logits.detach(), grads, gen.get_state()))
    (l0, g0, s0), (l1, g1, s1) = runs
    assert torch.equal(l0, l1) and torch.equal(s0, s1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_a_cpu_fit_launches_nothing(graph):
    before = SeluDropout.launches
    Trainer(_egcn(graph), lr=0.05, seed=3, device=CPU).fit(graph, epochs=2, n_classes=3)
    assert SeluDropout.launches == before


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


CARD_CASES = {  # shape, rate: EGCN's on the Amazon graph, narrower and ragged ones
    "amazon-0.7": ((77923, 2000), 0.7), "amazon-0": ((77923, 2000), 0.0),
    "width-1999": ((10007, 1999), 0.7), "width-6": ((517, 6), 0.5),
    "width-3": ((41, 3), 0.7), "one-element": ((1, 1), 0.5),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARD_CASES))
def test_kernels_equal_the_eager_composition_bit_for_bit(cuda, case):
    shape, rate = CARD_CASES[case]
    before = SeluDropout.launches
    eager, fused = _both(shape, rate, True, cuda)
    _assert_same(eager, fused)
    assert SeluDropout.launches - before == 2
    # the evaluation's pass: selu(W + b), no dropout
    gen = torch.Generator(device=cuda).manual_seed(5)
    w = torch.randn(shape, generator=gen, device=cuda)
    b = torch.randn(shape[1], generator=gen, device=cuda)
    with torch.no_grad():
        assert _same(embedding.selu_dropout(w, b, rate, False), _eager(w, b, rate, False, None))
    assert SeluDropout.launches - before == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["amazon-0.7", "width-1999", "width-3"])
def test_kernel_mask_equals_the_packed_compare(cuda, case):
    """The forward's mask words are :func:`pack` of ``u < keep``,
    and each kernel equals the plain version on the same uniforms."""
    shape, rate = CARD_CASES[case]
    gen = torch.Generator(device=cuda).manual_seed(11)
    w, u, dh = (torch.randn(shape, generator=gen, device=cuda) for _ in range(3))
    u = u.uniform_(generator=gen)
    b = torch.randn(shape[1], generator=gen, device=cuda)
    h, mask = forward_reference(w, b, u, rate)
    wp = w.clone().requires_grad_()
    fused = SeluDropout.apply(wp, b, u, rate)
    assert torch.equal(fused.grad_fn.saved_tensors[2], mask)
    (dw,) = torch.autograd.grad(fused, wp, dh)
    assert _same(fused.detach(), h)
    assert _same(dw, backward_reference(dh, w, b, mask, rate))


@pytest.mark.gpu
@pytest.mark.parametrize("rate", [0.7, 0.0])
def test_nan_and_inf_in_w_and_b_pass_as_in_the_eager_composition(cuda, rate):
    shape = (4099, 2000)
    gen = torch.Generator(device=cuda).manual_seed(13)
    w = torch.randn(shape, generator=gen, device=cuda) * 30
    b = torch.randn(shape[1], generator=gen, device=cuda)
    flat = w.view(-1)
    picks = torch.randperm(flat.numel(), generator=gen, device=cuda)[:3000]
    flat[picks[:1000]] = float("nan")
    flat[picks[1000:2000]] = float("inf")
    flat[picks[2000:]] = float("-inf")
    b[:3] = torch.tensor([float("nan"), float("inf"), float("-inf")], device=cuda)
    eager, fused = _both(shape, rate, True, cuda, w=w, b=b)
    assert torch.isnan(eager[0]).any() and torch.isinf(eager[0]).any()
    _assert_same(eager, fused)


@pytest.mark.gpu
def test_an_unaligned_weight_is_copied_before_the_kernel_reads_it(cuda):
    store = torch.randn(1 + 333 * 40, device=cuda)
    w = store[1:].view(333, 40)  # 4 bytes past the allocation's start
    b = torch.randn(40, device=cuda)
    assert w.data_ptr() % 16
    eager, fused = _both((333, 40), 0.7, True, cuda, w=w, b=b)
    _assert_same(eager, fused)


@pytest.fixture(scope="module")
def fit_graph():
    docs, labels = synthetic_corpus(n_docs=120, n_classes=4, seed=11)
    rng = np.random.default_rng(1)
    test_idx = rng.choice(120, 24, replace=False)
    val_idx = np.setdiff1d(rng.choice(120, 20, replace=False), test_idx)
    return Text2Graph(min_df=1, window_size=5).fit_transform(
        docs, labels, test_idx=test_idx, val_idx=val_idx)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,per_epoch", [("egcn", 3), ("gcn", 0)])
def test_a_graphed_fit_counts_three_launches_an_epoch(cuda, fit_graph, kind, per_epoch):
    """The train step's forward and backward and the evaluation's pass,
    whether they ran eagerly (epoch 1) or in a replay (the rest)."""
    cfg = ModelConfig(model=kind, n_hidden=16, dropout=0.5, embedding_dim=64)
    model = make_model(cfg, fit_graph.in_dim, 4, torch.Generator().manual_seed(7))
    trainer = Trainer(model, lr=0.05, seed=3, device=cuda)
    before = SeluDropout.launches
    trainer.fit(fit_graph, epochs=6, n_classes=4)
    torch.cuda.synchronize()
    assert trainer.graph_stats == {"replayed": 5, "eager": 1}
    assert SeluDropout.launches - before == per_epoch * 6
