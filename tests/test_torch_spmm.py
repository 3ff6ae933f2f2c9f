"""Port SpMM (ops/spmm_cuda.py plan + plain version, ops/spmm.py dispatch)
against the JAX package's segment path and its Pallas tile kernel (run in
interpret mode on the CPU, as tests/test_spmm_pallas.py runs it).

f32 tolerance rtol 1e-5: the three paths sum each row's edges in different
orders."""

import importlib.util
import pathlib

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu import Text2Graph as JaxText2Graph
from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.models import GCN as JaxGCN
from pytextgcn_tpu.ops import NormAdj as JaxNormAdj
from pytextgcn_tpu.ops.spmm import spmm as jax_spmm
from pytextgcn_tpu.ops.spmm import spmm_segment as jax_spmm_segment
from pytextgcn_tpu.train import Trainer as JaxTrainer
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.models import GCN, export_params
from pytextgcn_tpu_torch.ops import NormAdj
from pytextgcn_tpu_torch.ops import spmm_cuda
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment
from pytextgcn_tpu_torch.train import Trainer


def _graphs(rng, n, src, dst):
    w = rng.random(src.shape[0]).astype(np.float32) + 0.05
    arrays = dict(
        edge_src=src.astype(np.int32), edge_dst=dst.astype(np.int32), edge_w=w,
        y=np.zeros(n, np.int32), train_mask=np.zeros(n, bool),
        val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n // 2, n_docs=n - n // 2,
    )
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def _uniform_graph(rng, n=300, e=1500):
    return _graphs(rng, n, rng.integers(0, n, e), rng.integers(0, n, e))


def _skewed_graph(rng, n=520):
    # hubs and many rows with no edges at all (rows >= 5 receive few edges)
    src = rng.integers(0, 10, 4000)
    dst = np.concatenate([rng.integers(0, 5, 3500), rng.integers(0, n, 500)])
    return _graphs(rng, n, src, dst)


@pytest.mark.parametrize("make", [_uniform_graph, _skewed_graph], ids=["uniform", "skewed"])
def test_forward_matches_segment_and_pallas(make):
    rng = np.random.default_rng(0)
    g, jg = make(rng)
    x = rng.standard_normal((g.n_nodes, 16)).astype(np.float32)
    adj = NormAdj.from_graph(g, use_pallas=True, device="cpu")
    got = spmm(adj, torch.from_numpy(x)).numpy()
    want_segment = jax_spmm_segment(JaxNormAdj.from_graph(jg), jnp.asarray(x))
    want_pallas = jax_spmm(JaxNormAdj.from_graph(jg, use_pallas=True), jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want_segment), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(want_pallas), rtol=1e-5, atol=1e-6)
    # the port's own no-plan path agrees too
    seg = spmm_segment(NormAdj.from_graph(g, device="cpu"), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, seg, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("make", [_uniform_graph, _skewed_graph], ids=["uniform", "skewed"])
def test_gradient_matches_segment_and_pallas(make):
    rng = np.random.default_rng(1)
    g, jg = make(rng)
    x = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    tgt = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)

    xt = torch.from_numpy(x).requires_grad_(True)
    adj = NormAdj.from_graph(g, use_pallas=True, device="cpu")
    ((spmm(adj, xt) - torch.from_numpy(tgt)) ** 2).sum().backward()

    for jadj in (JaxNormAdj.from_graph(jg), JaxNormAdj.from_graph(jg, use_pallas=True)):
        want = jax.grad(lambda x: jnp.sum((jax_spmm(jadj, x) - tgt) ** 2))(jnp.asarray(x))
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_plan_cuts_long_rows_and_keeps_empty_ones():
    rng = np.random.default_rng(2)
    n_rows, n_cols = 7, 11  # rectangular, as the masked head's plans are
    rows = np.concatenate([np.zeros(3 * spmm_cuda.SEG_EDGES + 5, np.int64),
                           rng.integers(2, 5, 40)])
    cols = rng.integers(0, n_cols, rows.shape[0])
    w = rng.random(rows.shape[0]).astype(np.float32)
    csr = spmm_cuda.build_csr_plan(rows, cols, w, n_rows, n_cols, torch.device("cpu"))
    seg_ptr, seg_row = csr.seg_ptr.numpy(), csr.seg_row.numpy()
    assert np.all(np.diff(seg_ptr) <= spmm_cuda.SEG_EDGES)
    assert np.bincount(seg_row, minlength=n_rows).tolist() == [4, 1, 1, 1, 1, 1, 1]
    assert csr.split_row.tolist() == [0] and csr.split_ptr.tolist() == [0, 4]
    assert csr.seg_slot.tolist() == [0, 1, 2, 3] + [-1] * 6
    assert csr.n_partials == 4
    x = torch.from_numpy(rng.standard_normal((n_cols, 5)).astype(np.float32))
    dense = np.zeros((n_rows, n_cols), np.float64)
    np.add.at(dense, (rows, cols), w)
    np.testing.assert_allclose(spmm_cuda.spmm_csr(csr, x).numpy(), dense @ x.numpy(),
                               rtol=1e-5, atol=1e-5)
    # rows 1, 5 and 6 have no edges: exact zeros
    assert not spmm_cuda.spmm_csr(csr, x)[[1, 5, 6]].any()
    # the tolerance scale of kernel-vs-plain checks: |A| @ |x|
    np.testing.assert_allclose(spmm_cuda.spmm_csr_abs(csr, -x).numpy(),
                               np.abs(dense) @ np.abs(x.numpy()), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n_edges", [0, 1, 700, 701])
def test_plan_pairs_interleave_the_csr_arrays(n_edges):
    """The kernel's (col, val bits) pairs are the CSR arrays in CSR order;
    ``col`` and ``val`` are views of them."""
    rng = np.random.default_rng(n_edges)
    rows, cols = rng.integers(0, 40, n_edges), rng.integers(0, 30, n_edges)
    w = rng.standard_normal(n_edges).astype(np.float32)
    csr = spmm_cuda.build_csr_plan(rows, cols, w, 40, 30, torch.device("cpu"))
    order = np.argsort(rows, kind="stable")
    pairs = csr.pairs.numpy()
    assert csr.n_edges == n_edges and pairs.shape == (n_edges, 2)
    assert pairs.dtype == np.int32 and csr.pairs.is_contiguous()
    np.testing.assert_array_equal(csr.col.numpy(), cols[order])
    np.testing.assert_array_equal(csr.val.numpy(), w[order])
    np.testing.assert_array_equal(pairs[:, 1].view(np.float32), w[order])
    assert csr.row_ptr[-1] == n_edges and csr.seg_ptr[-1] == n_edges


def test_bf16_plan_rounds_input_and_accumulates_f32():
    rng = np.random.default_rng(3)
    g, _ = _uniform_graph(rng)
    x = torch.from_numpy(rng.standard_normal((g.n_nodes, 12)).astype(np.float32))
    adj = NormAdj.from_graph(g, use_pallas=True, pallas_dtype="bfloat16", device="cpu")
    got = spmm_cuda.spmm_plan(adj.plan, x)
    assert got.dtype == torch.float32
    want = spmm_cuda.spmm_csr_reference(adj.plan.fwd, x.bfloat16().float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    f32 = spmm_cuda.spmm_csr_reference(adj.plan.fwd, x)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), rtol=2e-2, atol=2e-2)


BF16_BAND = 2.0**-8


@pytest.mark.parametrize("make", [_uniform_graph, _skewed_graph], ids=["uniform", "skewed"])
def test_bf16_output_and_vjp_match_jax_pallas_bf16(make):
    """The flat bf16 CSR path against JAX's bf16 Pallas path (interpret
    mode). JAX rounds x to bf16 and each weighted gathered row again before
    its one-hot product (spmm_pallas.py:336-337); the port rounds x only and
    sums bf16 x times the f32 weight in f32. The band is 2^-8 (bf16's unit
    roundoff) of ``|A| @ |x|`` plus the self-loop term: port against JAX,
    and the port (one rounding a term) against the f32 result; JAX rounds
    twice, so it gets twice the band. The port is no further from the f32
    result than JAX."""
    rng = np.random.default_rng(6)
    g, jg = make(rng)
    x = rng.standard_normal((g.n_nodes, 16)).astype(np.float32)
    ct = rng.standard_normal((g.n_nodes, 16)).astype(np.float32)
    adj = NormAdj.from_graph(g, use_pallas=True, pallas_dtype="bfloat16", device="cpu")
    assert adj.plan.compute_dtype == "bfloat16"
    xt = torch.from_numpy(x).requires_grad_(True)
    out = spmm(adj, xt)
    (out * torch.from_numpy(ct)).sum().backward()

    jadj = JaxNormAdj.from_graph(jg, use_pallas=True, pallas_dtype="bfloat16")
    jout, vjp = jax.vjp(lambda u: jax_spmm(jadj, u), jnp.asarray(x))
    jgrad = vjp(jnp.asarray(ct))[0]

    xs = torch.from_numpy(x).requires_grad_(True)
    ref = spmm_segment(NormAdj.from_graph(g, device="cpu"), xs)
    (ref * torch.from_numpy(ct)).sum().backward()

    def scale(csr, v):
        v = torch.from_numpy(v)
        return (spmm_cuda.spmm_csr_abs(csr, v) + adj.self_w[:, None] * v.abs()).numpy()

    for got, jwant, want, mag in ((out, jout, ref, scale(adj.plan.fwd, x)),
                                  (xt.grad, jgrad, xs.grad, scale(adj.plan.bwd, ct))):
        got, want = got.detach().numpy(), want.detach().numpy()
        jwant = np.asarray(jwant)
        port_err = np.abs(got - want) / (mag + 1e-6)
        jax_err = np.abs(jwant - want) / (mag + 1e-6)
        assert port_err.max() <= BF16_BAND and jax_err.max() <= 2 * BF16_BAND
        assert (np.abs(got - jwant) <= BF16_BAND * mag + 1e-6).all()
        assert port_err.max() <= jax_err.max()


def test_bf16_fit_trajectory_matches_jax_trainer():
    """A short ``fit`` on the bf16 CSR path, dropout 0 and shared numpy
    parameters, against the JAX trainer on its bf16 Pallas path: losses
    within the bf16 band, each side's as close to its f32 run as bf16
    allows."""
    docs, labels = synthetic_corpus(n_docs=120, n_classes=3, seed=5)
    test_idx = np.arange(0, 120, 5)
    kw = dict(min_df=1, window_size=5)
    g = Text2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx)
    jg = JaxText2Graph(**kw).fit_transform(docs, labels, test_idx=test_idx)
    model = GCN(g.in_dim, 3, n_hidden_gcn=16, dropout=0.0,
                generator=torch.Generator().manual_seed(4))
    params = export_params(model)

    losses = {}
    for dtype in ("bfloat16", "float32"):
        jtrainer = JaxTrainer(JaxGCN(jg.in_dim, 3, n_hidden_gcn=16, dropout=0.0), lr=0.05,
                              use_pallas=True, pallas_dtype=dtype)
        jtrainer.params = jax.tree.map(jnp.asarray, params)
        losses["jax", dtype] = [r["loss"] for r in jtrainer.fit(jg, epochs=8, n_classes=3)]
        m = GCN(g.in_dim, 3, n_hidden_gcn=16, dropout=0.0)
        m.load_state_dict(model.state_dict())
        trainer = Trainer(m, lr=0.05, device="cpu", pallas_dtype=dtype)
        losses["port", dtype] = [r["loss"] for r in trainer.fit(g, epochs=8, n_classes=3)]
        assert trainer._adj.plan.compute_dtype == dtype
    np.testing.assert_allclose(losses["port", "bfloat16"], losses["jax", "bfloat16"],
                               rtol=BF16_BAND)
    np.testing.assert_allclose(losses["port", "float32"], losses["jax", "float32"], rtol=1e-4)
    for side in ("port", "jax"):
        np.testing.assert_allclose(losses[side, "bfloat16"], losses[side, "float32"],
                                   rtol=BF16_BAND)


def test_kernel_wrapper_takes_cuda_tensors_only():
    rng = np.random.default_rng(4)
    g, _ = _uniform_graph(rng, n=20, e=50)
    adj = NormAdj.from_graph(g, use_pallas=True, device="cpu")
    before = spmm_cuda.spmm_csr_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensors"):
        spmm_cuda.spmm_csr_kernel(adj.plan.fwd, torch.zeros(20, 4))
    assert spmm_cuda.spmm_csr_kernel.launches == before
    with pytest.raises(ValueError, match="compute_dtype"):
        NormAdj.from_graph(g, use_pallas=True, pallas_dtype="float16", device="cpu")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parent.parent / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("name", ["l1_resident", "no_gather", "cache_hints"])
def test_csr_timing_build_macro_is_read_by_the_source(name):
    """Each timing build of csrc/spmm_csr.cu that chip_smoke.py times sets
    a macro the source tests, so it is not the kernel itself under another
    name, and builds into a library of its own."""
    flags, _ = _chip_smoke().CSR_TIMING_BUILDS[name]
    (flag,) = flags
    assert flag.startswith("-D")
    src = pathlib.Path(spmm_cuda.__file__).resolve().parent.parent / "csrc" / "spmm_csr.cu"
    assert f"#ifdef {flag[2:]}\n" in src.read_text()
    build = spmm_cuda.SpmmCsrKernel(flags, "_" + name)
    assert build.lib.flags == flags and build.lib.so != spmm_cuda.spmm_csr_kernel.lib.so
