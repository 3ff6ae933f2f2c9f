"""The port's sharded hybrid (pytextgcn_tpu_torch/parallel/hybrid_sharded.py)
against the JAX package's (pytextgcn_tpu/parallel/hybrid_sharded.py).

One process plays every rank (tests/torch_rank_sim.py): each rank's
``HybridShardedAdj`` is built with a ``Mesh`` of no group and the
collectives are done by hand from the ranks' local math. Every array must
equal index ``rank`` of JAX's ``[D, ...]`` one bit for bit (D unpadded);
the products and gradients, JAX's ``spmm_hybrid_sharded`` and the
single-device operator within 2e-5 (f32, as tests/test_hybrid_sharded.py),
bf16 operands within 3e-2. The real collectives run in
tests/test_torch_multihost.py."""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.parallel import build_hybrid_sharded_adj as jax_build
from pytextgcn_tpu.parallel import make_mesh as jax_make_mesh
from pytextgcn_tpu.parallel.hybrid_sharded import spmm_hybrid_sharded as jax_spmm
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.ops import NormAdj
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment
from pytextgcn_tpu_torch.parallel import HybridShardedAdj, Mesh, build_hybrid_sharded_adj
from torch_rank_sim import hybrid_backward, hybrid_forward

CPU = torch.device("cpu")
ARRAYS = ("hot_rows", "hot_ranks", "a_hh", "hot_unpack")
HALO_ARRAYS = ("own_src", "own_dst", "own_w", "send_idx", "rem_pos", "rem_dst", "rem_w",
               "self_w")
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def sym_graphs(n_vocab=300, n_docs=200, n_edges=8000, seed=0, symmetric=True):
    """tests/test_hybrid_sharded.py's symmetric Zipfian graph, for both
    packages; ``symmetric=False`` drops the mirror of every edge."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    a = rng.choice(n, n_edges // 2, p=p).astype(np.int32)
    b = rng.choice(n, n_edges // 2, p=p).astype(np.int32)
    w_half = (rng.random(n_edges // 2) + 0.05).astype(np.float32)
    src, dst, w = ((np.concatenate([a, b]), np.concatenate([b, a]),
                    np.concatenate([w_half, w_half])) if symmetric else (a, b, w_half))
    zeros = np.zeros(n, bool)
    tm = zeros.copy()
    tm[n_vocab:] = True
    arrays = dict(edge_src=src, edge_dst=dst, edge_w=w, y=rng.integers(0, 3, n).astype(np.int32),
                  train_mask=tm, val_mask=zeros, test_mask=zeros, n_vocab=n_vocab,
                  n_docs=n_docs)
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def rank_adjs(g, d, **kw):
    return [build_hybrid_sharded_adj(g, Mesh(None, r, d, CPU), **kw) for r in range(d)]


def _bits(a):
    a = np.asarray(a.float() if torch.is_tensor(a) and a.dtype == torch.bfloat16 else a)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def inputs(g, h, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.n_nodes, h)).astype(np.float32),
            rng.standard_normal((g.n_nodes, h)).astype(np.float32))


def jax_pair(jadj, x, ct):
    """JAX's sharded hybrid on ``x`` and its x-cotangent for ``ct``."""
    f = jax.jit(lambda v: jax_spmm(jadj, v))
    grad = jax.jit(jax.grad(lambda v: jnp.vdot(jax_spmm(jadj, v), jnp.asarray(ct))))
    return np.asarray(f(jnp.asarray(x))), np.asarray(grad(jnp.asarray(x)))


@pytest.mark.parametrize("d", [2, 4, 8])
def test_rank_arrays_equal_jax_bit_for_bit(d):
    g, jg = sym_graphs(seed=d)
    jadj = jax_build(jg, jax_make_mesh(d), hot_k=128)
    for r, adj in enumerate(rank_adjs(g, d, hot_k=128)):
        assert isinstance(adj, HybridShardedAdj)
        assert (adj.rows_per, adj.k, adj.k_max, adj.n_pad, adj.n_shards) == (
            jadj.rows_per, jadj.k, jadj.k_max, jadj.n_pad, d)
        # D unpadded: JAX pads its shards' rows only for its fused kernel
        np.testing.assert_array_equal(_bits(adj.d_blk), _bits(np.asarray(jadj.d_blk)[r]))
        for name in ARRAYS:
            want = np.asarray(getattr(jadj, name))
            want = want if name in ("a_hh", "hot_unpack") else want[r]
            got = getattr(adj, name).numpy()
            assert got.dtype == want.dtype and np.array_equal(_bits(got), _bits(want)), name
        for name in HALO_ARRAYS:
            got = getattr(adj.halo_res, name).numpy()
            assert np.array_equal(got, np.asarray(getattr(jadj.halo_res, name))[r]), name
        assert adj.comm_rows_per_device == jadj.comm_rows_per_device
        assert adj.row_block == (g.n_nodes, r * adj.rows_per)


@pytest.mark.parametrize("fused", [False, True], ids=["matmul", "fused"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_forward_and_gradient_equal_jax_and_the_single_device(d, use_pallas, fused):
    # fused: the dual kernel's plain version on the CPU; JAX's unfused
    # sharded hybrid computes the same products (its HIGHEST dots)
    g, jg = sym_graphs(seed=d)
    adjs = rank_adjs(g, d, hot_k=128, use_pallas=use_pallas, fused=fused)
    assert all((a.halo_res.plan_own is not None) == use_pallas and a.fused == fused
               for a in adjs)
    x, ct = inputs(g, 12, seed=1)
    want, want_grad = jax_pair(jax_build(jg, jax_make_mesh(d), hot_k=128), x, ct)
    got = hybrid_forward(adjs, torch.from_numpy(x))
    got_grad = hybrid_backward(adjs, torch.from_numpy(ct))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got_grad.numpy(), want_grad, **TOL)
    single = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    ref = spmm_segment(single, xt)
    (ref * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(got.numpy(), ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(got_grad.numpy(), xt.grad.numpy(), **TOL)


def test_fused_equals_jax_fused_kernel():
    # JAX's fused path (its Pallas kernel in interpret mode, rows padded to
    # 512) against the port's fused path, forward and gradient
    g, jg = sym_graphs(seed=5)
    jadj = jax_build(jg, jax_make_mesh(4), hot_k=128, fused=True)
    assert jadj.fused and jadj.d_blk.shape[1] % 512 == 0
    adjs = rank_adjs(g, 4, hot_k=128, fused=True)
    assert all(a.d_blk.shape == (a.rows_per, 128) for a in adjs)
    x, ct = inputs(g, 32, seed=3)
    want, want_grad = jax_pair(jadj, x, ct)
    np.testing.assert_allclose(hybrid_forward(adjs, torch.from_numpy(x)).numpy(), want, **TOL)
    np.testing.assert_allclose(hybrid_backward(adjs, torch.from_numpy(ct)).numpy(), want_grad,
                               **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["matmul", "fused"])
def test_bf16_compute_dtype(fused):
    # bf16 D, operands and wire, f32 products and sums: JAX's bf16 sharded
    # hybrid within bf16 tolerance, forward and gradient
    g, jg = sym_graphs(seed=13)
    adjs = rank_adjs(g, 4, hot_k=128, compute_dtype="bfloat16", fused=fused)
    assert all(a.d_blk.dtype == torch.bfloat16 and a.halo_res.compute_dtype == "bfloat16"
               for a in adjs)
    x, ct = inputs(g, 8, seed=3)
    want, want_grad = jax_pair(jax_build(jg, jax_make_mesh(4), hot_k=128,
                                         compute_dtype="bfloat16"), x, ct)
    got = hybrid_forward(adjs, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(hybrid_backward(adjs, torch.from_numpy(ct), torch.bfloat16).numpy(),
                               want_grad, rtol=3e-2, atol=3e-2)


def test_empty_residual_and_one_rank_through_autograd():
    # K covers every node: the residual carries only the self-loop term; a
    # group of one runs the real autograd function (its collectives are the
    # identity) against the single-device operator, forward and gradient
    g, _ = sym_graphs(n_vocab=40, n_docs=40, n_edges=1200, seed=11)
    adj = rank_adjs(g, 1, hot_k=g.n_nodes)[0]
    assert adj.k == g.n_nodes and adj.halo_res.n_own == 0
    x, ct = inputs(g, 8, seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(adj, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    single = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    xr = torch.from_numpy(x).requires_grad_()
    ref = spmm_segment(single, xr)
    (ref * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **TOL)
    assert adj.wire_rows == 0  # a group of one moves nothing


def test_comm_rows_are_jax_s_and_below_the_all_gather():
    # tests/test_hybrid_sharded.py:91-123 without the compiled-HLO audit:
    # the ring accounting equals JAX's, and at N >> K the wire stays below
    # the all-gather partition's (D-1) * rows_per
    g, jg = sym_graphs(n_vocab=800, n_docs=800, n_edges=20000, seed=5)
    adj = rank_adjs(g, 8, hot_k=128)[0]
    assert adj.comm_rows_per_device == jax_build(jg, jax_make_mesh(8),
                                                 hot_k=128).comm_rows_per_device
    g2, _ = sym_graphs(n_vocab=4000, n_docs=4000, n_edges=40000, seed=5)
    adj2 = build_hybrid_sharded_adj(g2, Mesh(None, 0, 8, CPU), hot_k=128)
    assert adj2.comm_rows_per_device < (8 - 1) * adj2.rows_per


def test_k_zero_and_auto_choosing_none_mean_the_pure_halo(monkeypatch):
    from pytextgcn_tpu_torch.parallel import hybrid_sharded

    g, _ = sym_graphs()
    mesh = Mesh(None, 0, 2, CPU)
    assert build_hybrid_sharded_adj(g, mesh, hot_k=0) is None
    assert build_hybrid_sharded_adj(g, mesh, hot_k=None) is None
    # 'auto' goes through the H100 chooser, reading D once when fused
    calls = []

    def chooser(*args, **kw):
        calls.append(kw["d_reads"])
        return 0

    monkeypatch.setattr(hybrid_sharded, "choose_hot_k", chooser)
    assert build_hybrid_sharded_adj(g, mesh, hot_k="auto") is None
    assert build_hybrid_sharded_adj(g, mesh, hot_k="auto", fused=True) is None
    assert calls == [2, 1]


def test_asymmetric_graph_auto_warns_and_forced_k_raises(monkeypatch):
    from pytextgcn_tpu_torch.parallel import hybrid_sharded

    g, _ = sym_graphs(seed=2, symmetric=False)
    mesh = Mesh(None, 0, 2, CPU)
    monkeypatch.setattr(hybrid_sharded, "choose_hot_k", lambda *a, **k: 128)
    with pytest.warns(UserWarning, match="not weight-symmetric"):
        assert build_hybrid_sharded_adj(g, mesh, hot_k="auto") is None
    with pytest.raises(ValueError, match="weight-symmetric"):
        build_hybrid_sharded_adj(g, mesh, hot_k=128)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        g_sym, _ = sym_graphs(seed=2)
        assert build_hybrid_sharded_adj(g_sym, mesh, hot_k="auto") is not None
