"""The port's ``hybrid_k='auto'`` against the JAX package's: the cost model
(ops/hybrid.py ``choose_hot_k``) and the masked head's restricted chooser
(ops/restricted.py) pick the same K as the JAX functions when the JAX
module is given the port's constants (patched inside each test only), on
several degree distributions; plus the 'auto' fallback on a directed graph
and the residual modes.

The port's model adds one term to the JAX form, the hybrid's fixed passes
over ``[N, H]`` (``_HYBRID_NH_NS``, measured on the card): the equality
tests set it to 0, and one more test holds the port's choice to the JAX
form's costs plus that term. The JAX restricted chooser keeps two numbers
as literals (its slab's bandwidth, 2.2e11 B/s, and its width, 128): the
port's chooser takes them as arguments, and the test passes it those
literals with the patched constants, so that both run one form on one set
of numbers.
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.ops import hybrid as jhybrid
from pytextgcn_tpu.ops import restricted as jrestricted
from pytextgcn_tpu_torch.core.graph import TextGraph, gcn_normalize_np
from pytextgcn_tpu_torch.ops import NormAdj, hybrid
from pytextgcn_tpu_torch.ops.restricted import choose_restricted_k
from pytextgcn_tpu_torch.ops.spmm import spmm
from pytextgcn_tpu_torch.ops.spmm_cuda import SpmmPlan

SMALL_K = (0, 16, 32, 64, 128, 256, 512)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edges(kind: str, n=3000, e=60_000, seed=0):
    """Directed edge lists of several degree distributions, mirrored."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        a = rng.integers(0, n, e)
    elif kind == "star":  # a handful of hubs on half the edges
        a = np.where(rng.random(e) < 0.5, rng.integers(0, 8, e), rng.integers(0, n, e))
    else:  # zipf with exponent `kind`
        a = np.minimum(rng.zipf(float(kind), e) - 1, n - 1)
    b = rng.integers(0, n, e)
    return np.concatenate([a, b]), np.concatenate([b, a]), n


def _patch_jax_constants(monkeypatch, h, scale=1.0):
    """The port's cost-model constants into the JAX module, its per-edge
    rates at width ``h`` times ``scale``; the port's extra term off."""
    monkeypatch.setattr(hybrid, "_HYBRID_NH_NS", 0.0)
    for name in ("_HBM_BPS", "_MXU_F32_HIGHEST", "_MXU_BF16_FACTOR", "_MXU_SPLIT_DENSE",
                 "_PAD_FACTOR"):
        monkeypatch.setattr(jhybrid, name, getattr(hybrid, name))
    # JAX's segment residual costs 4 * _GATHER_NS an edge
    seg_ns = hybrid.segment_edge_ns(h) * scale
    monkeypatch.setattr(jhybrid, "_GATHER_NS", seg_ns / 4)
    return hybrid.csr_edge_ns(h) * scale, seg_ns


SETTINGS = {  # (h, itemsize, d_reads, batch, segment_resid, dense_split)
    "split2-h100": (100, 4, 1, 1, False, True),
    "f32-two-mm-h43": (43, 4, 2, 1, False, False),
    "bf16-h100": (100, 2, 1, 1, False, False),
    "ep-batch6": (100, 4, 1, 6, False, True),
    "segment-h43": (43, 4, 1, 1, True, True),
}


@pytest.mark.parametrize("kind", ["uniform", "star", "1.3", "1.8"])
@pytest.mark.parametrize("scale", [1.0, 30.0], ids=["h100-rates", "slow-edges"])
def test_choose_hot_k_matches_jax_under_the_ports_constants(monkeypatch, kind, scale):
    src, dst, n = _edges(kind)
    picked = []
    for h, itemsize, d_reads, batch, seg, split in SETTINGS.values():
        edge_ns, seg_ns = _patch_jax_constants(monkeypatch, h, scale)
        kw = dict(h=h, itemsize=itemsize, candidates=SMALL_K, dst=dst, d_reads=d_reads,
                  batch=batch, segment_resid=seg, dense_split=split)
        want = jhybrid.choose_hot_k(src, n, edge_ns=edge_ns, **kw)
        got = hybrid.choose_hot_k(src, n, edge_ns=edge_ns, seg_ns=seg_ns, **kw)
        assert got == want, (kind, h, itemsize, d_reads, batch, seg, split)
        if scale == 1.0:  # the port's own rates are its defaults
            assert hybrid.choose_hot_k(src, n, **kw) == want
        picked.append(got)
    if kind == "star" and scale == 30.0:
        assert max(picked) > 0  # the model does choose a hot set somewhere


@pytest.mark.parametrize("kind", ["star", "1.3"])
def test_the_ports_fixed_term_adds_to_every_hot_set(monkeypatch, kind):
    """With its fixed passes over [N, H], the port picks the K that
    minimizes the JAX form's cost plus that term for every K > 0."""
    src, dst, n = _edges(kind)
    h, nh_ns = 100, hybrid._HYBRID_NH_NS
    fixed = nh_ns * n * h
    assert fixed > 0
    edge_ns, seg_ns = _patch_jax_constants(monkeypatch, h, 30.0)
    monkeypatch.setattr(hybrid, "_HYBRID_NH_NS", nh_ns)  # the port's term back on
    deg = np.bincount(src, minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-deg, kind="stable")] = np.arange(n)
    costs = {0: len(src) * edge_ns}
    for k in SMALL_K[1:]:
        resid = int(np.sum((rank[src] >= k) & (rank[dst] >= k)))
        costs[k] = jhybrid._predict_cost_ns(n, len(src), resid, k, h, 4, d_reads=1,
                                            dense_split=True, edge_ns=edge_ns) + fixed
    got = hybrid.choose_hot_k(src, n, h=h, candidates=SMALL_K, dst=dst, d_reads=1,
                              dense_split=True, edge_ns=edge_ns, seg_ns=seg_ns)
    assert got == min(costs, key=costs.get)


@pytest.mark.parametrize("kind", ["uniform", "star", "1.3"])
@pytest.mark.parametrize("scale", [1.0, 300.0], ids=["h100-rates", "slow-edges"])
def test_restricted_chooser_matches_jax(monkeypatch, kind, scale):
    src, dst, n = _edges(kind, n=12_000, e=120_000, seed=1)
    rng = np.random.default_rng(2)
    y = rng.integers(0, 4, n).astype(np.int32)
    tm = np.zeros(n, bool)
    tm[rng.choice(n, n // 3, replace=False)] = True
    arrays = dict(edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32),
                  edge_w=np.ones(len(src), np.float32), y=y, train_mask=tm,
                  val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
                  n_vocab=n // 2, n_docs=n - n // 2)
    rows = np.flatnonzero(tm)
    h = 43
    edge_ns, seg_ns = hybrid.csr_edge_ns(h) * scale, hybrid.segment_edge_ns(h) * scale
    mxu = hybrid._MXU_F32_HIGHEST
    monkeypatch.setattr(jhybrid, "_EDGE_NS", edge_ns)
    monkeypatch.setattr(jhybrid, "_GATHER_NS", seg_ns / 4)
    monkeypatch.setattr(jhybrid, "_MXU_F32_HIGHEST", mxu)
    # the CSR plan pads nothing
    monkeypatch.setattr(jrestricted, "_padded_slots", lambda dst_l, m, *a, **k: len(dst_l))
    jr = jrestricted.build_restricted_adj(JaxTextGraph(**arrays), rows, hot_k="auto",
                                          resid_mode="segment")
    local = np.full(n, -1)
    local[rows] = np.arange(len(rows))
    r_src = src[local[dst] >= 0]
    got = choose_restricted_k(r_src, n, len(rows), h=128, slab_bps=2.2e11, slab_flops=mxu,
                              edge_ns=edge_ns, seg_ns=seg_ns)
    assert got == jr.k
    if kind == "star" and scale > 1:
        assert got > 0


def test_auto_on_a_directed_graph_warns_and_builds_the_csr_plan(monkeypatch):
    rng = np.random.default_rng(4)
    n, e = 400, 5000
    g = TextGraph(edge_src=rng.integers(0, n, e).astype(np.int32),
                  edge_dst=rng.integers(0, n, e).astype(np.int32),
                  edge_w=rng.random(e).astype(np.float32), y=np.zeros(n, np.int32),
                  train_mask=np.zeros(n, bool), val_mask=np.zeros(n, bool),
                  test_mask=np.zeros(n, bool), n_vocab=200, n_docs=200)
    # make the model want a hot set, so that the symmetry audit runs
    monkeypatch.setattr(hybrid, "choose_hot_k", lambda *a, **k: 64)
    for graph in (g, dataclasses.replace(g, weight_symmetric=True)):  # both audits
        with pytest.warns(UserWarning, match="not weight-symmetric"):
            adj = NormAdj.from_graph(graph, hybrid_k="auto", device="cpu")
        assert isinstance(adj.plan, SpmmPlan)
    with pytest.raises(ValueError, match="weight-symmetric"):  # an explicit K still raises
        NormAdj.from_graph(g, hybrid_k=64, device="cpu")


def _sym_graph(seed=5, n=500, e=8000):
    rng = np.random.default_rng(seed)
    a = np.minimum(rng.zipf(1.4, e) - 1, n - 1)
    b = rng.integers(0, n, e)
    w = (rng.random(e) + 0.1).astype(np.float32)
    zeros = np.zeros(n, bool)
    return TextGraph(edge_src=np.concatenate([a, b]).astype(np.int32),
                     edge_dst=np.concatenate([b, a]).astype(np.int32),
                     edge_w=np.concatenate([w, w]), y=np.zeros(n, np.int32),
                     train_mask=zeros, val_mask=zeros, test_mask=zeros,
                     n_vocab=n // 2, n_docs=n - n // 2, weight_symmetric=True)


@pytest.mark.parametrize("f32_mode", ["highest", "split2"])
def test_resid_modes_give_the_same_spmm(f32_mode):
    g = _sym_graph()
    x = torch.tensor(np.random.default_rng(1).standard_normal((g.n_nodes, 12)),
                     dtype=torch.float32)
    ct = torch.tensor(np.random.default_rng(2).standard_normal((g.n_nodes, 12)),
                      dtype=torch.float32)
    outs, grads = {}, {}
    for mode in ("pallas", "segment", "auto"):
        adj = NormAdj.from_graph(g, hybrid_k=64, hybrid_resid=mode, hybrid_f32_mode=f32_mode,
                                 device="cpu")
        assert isinstance(adj.plan, hybrid.HybridPlan) and adj.plan.n_resid > 0
        assert (adj.plan.res is None) == (mode == "segment")
        assert (adj.plan.seg_src is None) == (mode != "segment")
        xv = x.clone().requires_grad_(True)
        outs[mode] = spmm(adj, xv)
        (outs[mode] * ct).sum().backward()
        grads[mode] = xv.grad
    # 'auto' prices the CSR kernel below the segment path at every width
    assert hybrid.csr_edge_ns(12) < hybrid.segment_edge_ns(12)
    for mode in ("segment", "auto"):
        torch.testing.assert_close(outs[mode], outs["pallas"], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(grads[mode], grads["pallas"], rtol=1e-5, atol=1e-6)


def test_auto_builds_what_the_model_picks_and_prices_it():
    g = _sym_graph()
    src, dst = np.asarray(g.edge_src, np.int64), np.asarray(g.edge_dst, np.int64)
    k = hybrid.choose_hot_k(src, g.n_nodes, h=100, itemsize=4, dst=dst, d_reads=1,
                            dense_split=True)
    adj = NormAdj.from_graph(g, hybrid_k="auto", h_hint=100, device="cpu")
    if k:
        assert isinstance(adj.plan, hybrid.HybridPlan) and adj.plan.k == k
        assert adj.plan.predicted_spmm_ns > 0
    else:
        assert isinstance(adj.plan, SpmmPlan)  # declined: the CSR plan follows
    norm_w, _ = gcn_normalize_np(src, dst, g.edge_w, g.n_nodes)
    forced = hybrid.build_hybrid_plan(src, dst, norm_w, g.n_nodes, hot_k=128, h_hint=100,
                                      validate="fast")
    assert forced.predicted_spmm_ns == pytest.approx(hybrid._predict_cost_ns(
        g.n_nodes, len(src), forced.n_resid, 128, 100, 4, d_reads=1, dense_split=True))
    assert forced.predicted_spmm_ns > hybrid._HYBRID_NH_NS * g.n_nodes * 100


def test_edge_rates_interpolate_over_the_width():
    t = hybrid._CSR_EDGE_NS
    ws = sorted(t)
    assert hybrid.csr_edge_ns(ws[0]) == t[ws[0]] and hybrid.csr_edge_ns(0) == t[ws[0]]
    assert hybrid.csr_edge_ns(2 * ws[-1]) == pytest.approx(2 * t[ws[-1]])
    mid = (ws[-2] + ws[-1]) / 2
    assert hybrid.csr_edge_ns(mid) == pytest.approx((t[ws[-2]] + t[ws[-1]]) / 2)
    for w in ws:
        assert hybrid.segment_edge_ns(w) > hybrid.csr_edge_ns(w)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        hybrid.choose_hot_k(np.zeros(0, np.int64), 10)  # an empty graph picks 0 quietly
