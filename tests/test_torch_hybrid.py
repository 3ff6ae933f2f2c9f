"""Port hybrid SpMM (ops/hybrid.py, its NormAdj/spmm wiring, the Trainer
and CLI flags) against the JAX package's ops/hybrid.py on the CPU, where
JAX runs its Pallas kernels in interpret mode (tests/test_spmm_hybrid.py).

Tolerances: the f32 modes within 3e-5 of the largest output
(tests/test_spmm_hybrid.py:73-79, the split2 band); bf16 at 1e-2 of it
(operands rounded to bf16, relative error up to 2^-8 per product)."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.ops import NormAdj as JaxNormAdj
from pytextgcn_tpu.ops import hybrid as jhybrid
from pytextgcn_tpu.ops.spmm import spmm as jax_spmm
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch.config import check_ported, hybrid_k_arg, parse_config
from pytextgcn_tpu_torch.core.graph import TextGraph, gcn_normalize_np
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops import NormAdj, hybrid
from pytextgcn_tpu_torch.ops.fused_dual import fused_dual_kernel
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment
from pytextgcn_tpu_torch.ops.spmm_cuda import SpmmPlan
from pytextgcn_tpu_torch.train import Trainer

F32_BAND, BF16_BAND = 3e-5, 1e-2


def _graphs(n_vocab=300, n_docs=200, n_edges=8000, seed=0, symmetric=True):
    """Zipf-skewed endpoints stored in both directions with one weight, as a
    normalized text graph is (the JAX tests' _rand_graph)."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    a = rng.choice(n, n_edges // 2, p=p).astype(np.int32)
    b = rng.choice(n, n_edges // 2, p=p).astype(np.int32)
    w_half = (rng.random(n_edges // 2) + 0.05).astype(np.float32)
    w_back = w_half if symmetric else (rng.random(n_edges // 2) + 0.05).astype(np.float32)
    test = np.zeros(n, bool)
    test[rng.choice(np.arange(n_vocab, n), 40, replace=False)] = True
    arrays = dict(
        edge_src=np.concatenate([a, b]), edge_dst=np.concatenate([b, a]),
        edge_w=np.concatenate([w_half, w_back]), y=rng.integers(0, 3, n).astype(np.int32),
        train_mask=np.r_[np.zeros(n_vocab, bool), np.ones(n_docs, bool)] & ~test,
        val_mask=np.zeros(n, bool), test_mask=test, n_vocab=n_vocab, n_docs=n_docs,
    )
    return TextGraph(**arrays), JaxTextGraph(**arrays)


MODES = {
    # name: (port NormAdj kwargs, JAX NormAdj kwargs, band)
    "split2": (dict(), dict(), F32_BAND),
    "highest": (dict(hybrid_f32_mode="highest"), dict(hybrid_f32_mode="highest"), F32_BAND),
    "highest_fused": (dict(hybrid_f32_mode="highest", hybrid_fused=True),
                      dict(hybrid_f32_mode="highest", hybrid_fused=True), F32_BAND),
    "bf16": (dict(pallas_dtype="bfloat16"), dict(pallas_dtype="bfloat16"), BF16_BAND),
}


def _bits(a):
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16) if a.dtype == torch.bfloat16 else a).numpy()
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("mode", ["split2", "highest", "bf16"])
def test_plan_is_bitwise_equal_to_jax(mode):
    g, _ = _graphs()
    src, dst = np.asarray(g.edge_src), np.asarray(g.edge_dst)
    w, _ = gcn_normalize_np(src, dst, g.edge_w, g.n_nodes)
    cd = "bfloat16" if mode == "bf16" else "float32"
    f32_mode = "highest" if mode == "highest" else "split2"
    plan = hybrid.build_hybrid_plan(src, dst, w, g.n_nodes, hot_k=200, compute_dtype=cd,
                                    f32_mode=f32_mode)
    jplan = jhybrid.build_hybrid_plan(src, dst, w, g.n_nodes, hot_k=200, compute_dtype=cd,
                                      resid_f32_mode=f32_mode)
    assert plan.k == jplan.k == 128  # rounded down to a multiple of 128
    np.testing.assert_array_equal(plan.hot_ids.numpy(), np.asarray(jplan.hot_ids))
    assert plan.n_resid == jplan.n_resid > 0
    assert (plan.d_lo is None) == (jplan.d_lo is None) == (mode != "split2")
    n = g.n_nodes
    assert plan.d_full.shape == (n, 128)  # JAX pads the split's rows to 512
    np.testing.assert_array_equal(_bits(plan.d_full), _bits(np.asarray(jplan.d_full)[:n]))
    if plan.d_lo is not None:
        assert plan.d_lo.abs().max() > 0
        np.testing.assert_array_equal(_bits(plan.d_lo), _bits(np.asarray(jplan.d_lo)[:n]))
    np.testing.assert_array_equal(_bits(plan.a_hh), _bits(jplan.a_hh))
    assert isinstance(plan.res, SpmmPlan) and plan.res.fwd.n_edges == plan.n_resid


@pytest.mark.parametrize("mode", list(MODES))
def test_spmm_hybrid_forward_and_vjp_match_jax_and_segment(mode):
    kw, jkw, band = MODES[mode]
    g, jg = _graphs(seed=1)
    adj = NormAdj.from_graph(g, hybrid_k=128, device="cpu", **kw)
    assert isinstance(adj.plan, hybrid.HybridPlan)
    assert (adj.plan.d_lo is not None) == (mode == "split2")
    jadj = JaxNormAdj.from_graph(jg, hybrid_k=128, **jkw)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((g.n_nodes, 100)).astype(np.float32)
    ct = rng.standard_normal((g.n_nodes, 100)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    before = dict(fused_dual_kernel.launches)
    out = spmm(adj, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    assert fused_dual_kernel.launches == before  # CPU: the plain versions

    jout, vjp = jax.jit(lambda v: jax.vjp(lambda u: jax_spmm(jadj, u), v))(jnp.asarray(x))
    jgrad = jax.jit(vjp)(jnp.asarray(ct))[0]
    seg_adj = NormAdj.from_graph(g, device="cpu")
    xs = torch.from_numpy(x).requires_grad_(True)
    seg = spmm_segment(seg_adj, xs)
    (seg * torch.from_numpy(ct)).sum().backward()
    for got, jax_want, seg_want in ((out.detach(), jout, seg.detach()),
                                    (xt.grad, jgrad, xs.grad)):
        scale = float(seg_want.abs().max())
        assert float((got - seg_want).abs().max()) / scale < band
        assert float((got - torch.from_numpy(np.array(jax_want))).abs().max()) / scale < band


def test_device_block_build_matches_host_build():
    g, _ = _graphs(seed=3)
    src, dst = np.asarray(g.edge_src, np.int64), np.asarray(g.edge_dst, np.int64)
    w, _ = gcn_normalize_np(src, dst, g.edge_w, g.n_nodes)
    k = 32
    deg = np.bincount(src, minlength=g.n_nodes)
    hot = np.sort(np.argsort(-deg, kind="stable")[:k])
    rank = np.full(g.n_nodes, -1, np.int64)
    rank[hot] = np.arange(k)
    sel = rank[src] >= 0
    args = (dst[sel], rank[src[sel]], w[sel], g.n_nodes, k)
    host = hybrid.dense_block_host(*args)
    dev = hybrid.dense_block_device(*args, device=torch.device("cpu"))
    np.testing.assert_allclose(dev.numpy(), host, rtol=1e-6, atol=0)


def test_asymmetric_adjacency_raises_and_k_zero_is_off():
    g, _ = _graphs(seed=4, symmetric=False)
    with pytest.raises(ValueError, match="weight-symmetric"):
        NormAdj.from_graph(g, hybrid_k=128, device="cpu")
    fast = dataclasses.replace(g, weight_symmetric=True)  # the randomized audit
    with pytest.raises(ValueError, match="randomized symmetry audit"):
        NormAdj.from_graph(fast, hybrid_k=128, device="cpu")
    assert NormAdj.from_graph(g, hybrid_k=0, device="cpu").plan is None
    assert isinstance(NormAdj.from_graph(g, hybrid_k=0, use_pallas=True, device="cpu").plan,
                      SpmmPlan)
    # 'auto' never raises on a directed operator: it declines or falls back,
    # and the CSR plan follows
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert isinstance(NormAdj.from_graph(g, hybrid_k="auto", device="cpu").plan, SpmmPlan)


def test_fit_trajectory_matches_jax_trainer():
    g, jg = _graphs(seed=5)
    model = GCN(g.in_dim, 3, n_hidden_gcn=16, dropout=0.0,
                generator=torch.Generator().manual_seed(1))
    jtrainer = JaxTrainer(JaxGCN(jg.in_dim, 3, n_hidden_gcn=16, dropout=0.0), lr=0.05,
                          hybrid_k=128)
    jtrainer.params = jax.tree.map(jnp.asarray, export_params(model))
    jhist = jtrainer.fit(jg, epochs=10, n_classes=3)
    jmetrics = jtrainer.evaluate(jg, n_classes=3)

    trainer = Trainer(model, lr=0.05, device="cpu", hybrid_k=128)
    hist = trainer.fit(g, epochs=10, n_classes=3)
    metrics = trainer.evaluate(g, n_classes=3)
    assert isinstance(trainer._adj.plan, hybrid.HybridPlan)
    assert trainer._adj.plan.d_lo is not None  # the default f32 mode is split2
    np.testing.assert_allclose([r["loss"] for r in hist], [r["loss"] for r in jhist],
                               rtol=1e-3)
    assert metrics == pytest.approx(jmetrics, abs=1e-6)


def test_cli_takes_an_integer_k_and_refuses_auto():
    cfg = parse_config(["--train-hybrid-k", "4096", "--train-hybrid-fused", "on",
                        "--train-hybrid-f32-mode", "highest"])
    check_ported(cfg)
    assert hybrid_k_arg(cfg.train) == 4096
    assert hybrid_k_arg(parse_config([]).train) is None  # 'auto-tpu' is off on a GPU
    assert hybrid_k_arg(parse_config(["--train-hybrid-k", "0"]).train) is None
    auto = parse_config(["--train-hybrid-k", "auto"])
    check_ported(auto)  # the cost model runs on H100 constants now
    assert hybrid_k_arg(auto.train) == "auto"
    with pytest.raises(SystemExit, match="hybrid-f32-mode"):
        check_ported(parse_config(["--train-hybrid-f32-mode", "tf32"]))
    with pytest.raises(SystemExit, match="integer hot-set size"):
        hybrid_k_arg(parse_config(["--train-hybrid-k", "many"]).train)
