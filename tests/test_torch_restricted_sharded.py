"""The port's sharded masked head
(pytextgcn_tpu_torch/parallel/restricted_sharded.py) against the JAX
package's (pytextgcn_tpu/parallel/restricted_sharded.py), as
tests/test_restricted_sharded.py holds JAX's: the head equals the full SpMM
at the train rows, is exactly zero elsewhere, and its gradient is exact.

One process plays every rank (tests/torch_rank_sim.py). The arrays must
equal index ``rank`` of JAX's ``[D, ...]`` ones bit for bit; the products
and gradients, JAX's and the single-device operator's within rtol 1e-4,
atol 1e-5 (tests/test_restricted_sharded.py:49-106). JAX's ``'auto'`` K is
priced on TPU constants and the port's on H100 ones, so the parity tests
pass K explicitly (None, 128) and a separate test holds the port's
``'auto'`` to ``choose_restricted_k``. The trainer over real ranks
('halo', 'hybrid', 'allgather') runs in tests/test_torch_multihost.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.ops.spmm import spmm as jax_spmm
from pytextgcn_tpu.parallel import build_restricted_sharded_adj as jax_build
from pytextgcn_tpu.parallel import make_mesh as jax_make_mesh
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.ops import NormAdj
from pytextgcn_tpu_torch.ops.restricted import choose_restricted_k
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment
from pytextgcn_tpu_torch.parallel import (HaloAdj, Mesh, ReplicatedHead, RestrictedShardedAdj,
                                          build_restricted_sharded_adj)
from torch_rank_sim import (halo_backward, halo_forward, restricted_backward,
                            restricted_forward)

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-5)
ARRAYS = ("d_blk", "out_rows", "hot_rows")
HALO_ARRAYS = ("own_src", "own_dst", "own_w", "send_idx", "rem_pos", "rem_dst", "rem_w",
               "self_w")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def graphs(n_vocab=300, n_docs=200, n_edges=8000, seed=0):
    """tests/test_restricted_sharded.py's Zipfian graph, for both packages."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    zeros = np.zeros(n, bool)
    tm, vm, sm = zeros.copy(), zeros.copy(), zeros.copy()
    tm[n_vocab:n_vocab + 150] = True
    vm[n_vocab + 150:n_vocab + 175] = True
    sm[n_vocab + 175:] = True
    arrays = dict(edge_src=rng.choice(n, n_edges, p=p).astype(np.int32),
                  edge_dst=rng.choice(n, n_edges, p=p).astype(np.int32),
                  edge_w=(rng.random(n_edges) + 0.05).astype(np.float32),
                  y=rng.integers(0, 4, n).astype(np.int32), train_mask=tm, val_mask=vm,
                  test_mask=sm, n_vocab=n_vocab, n_docs=n_docs)
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def rank_adjs(g, rows, d, **kw):
    return [build_restricted_sharded_adj(g, rows, Mesh(None, r, d, CPU), **kw)
            for r in range(d)]


def forward(adjs, x):
    if isinstance(adjs[0], HaloAdj):
        return halo_forward(adjs, x)
    return restricted_forward(adjs, x)


def backward(adjs, ct):
    if isinstance(adjs[0], HaloAdj):
        return halo_backward(adjs, ct)
    return restricted_backward(adjs, ct)


@pytest.mark.parametrize("hot_k", [None, 128], ids=["halo", "hybrid128"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_rank_arrays_equal_jax_bit_for_bit(d, hot_k):
    g, jg = graphs(seed=d)
    rows = np.flatnonzero(g.train_mask)
    jadj = jax_build(jg, rows, jax_make_mesh(d), hot_k=hot_k)
    for r, adj in enumerate(rank_adjs(g, rows, d, hot_k=hot_k)):
        halo = adj if hot_k is None else adj.halo_res
        jhalo = jadj if hot_k is None else jadj.halo_res
        assert isinstance(adj, HaloAdj if hot_k is None else RestrictedShardedAdj)
        for name in HALO_ARRAYS:
            assert np.array_equal(getattr(halo, name).numpy(),
                                  np.asarray(getattr(jhalo, name))[r]), name
        assert adj.comm_rows_per_device == jadj.comm_rows_per_device
        if hot_k is None:
            continue
        assert (adj.k, adj.k_max, adj.m_max, adj.rows_per) == (jadj.k, jadj.k_max, jadj.m_max,
                                                               jadj.rows_per)
        for name in ARRAYS:
            got, want = getattr(adj, name).numpy(), np.asarray(getattr(jadj, name))[r]
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(adj.hot_unpack.numpy(), np.asarray(jadj.hot_unpack))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
@pytest.mark.parametrize("hot_k", [None, 128], ids=["halo", "hybrid128"])
def test_head_equals_the_full_rows_and_is_zero_elsewhere(hot_k, use_pallas):
    g, jg = graphs(seed=1)
    rows = np.flatnonzero(g.train_mask)
    adjs = rank_adjs(g, rows, 8, hot_k=hot_k, use_pallas=use_pallas)
    x = np.random.default_rng(2).standard_normal((g.n_nodes, 16)).astype(np.float32)
    got = forward(adjs, torch.from_numpy(x)).numpy()
    full = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    ref = spmm_segment(full, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got[rows], ref[rows], **TOL)
    other = np.ones(g.n_nodes, bool)
    other[rows] = False
    assert np.all(got[other] == 0.0)
    jadj = jax_build(jg, rows, jax_make_mesh(8), hot_k=hot_k)
    want = np.asarray(jax.jit(lambda v: jax_spmm(jadj, v))(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, **TOL)


def test_forced_k_uses_the_hot_block():
    g, _ = graphs(seed=4)
    rows = np.flatnonzero(g.train_mask)
    adj = build_restricted_sharded_adj(g, rows, Mesh(None, 0, 8, CPU), hot_k=128)
    assert isinstance(adj, RestrictedShardedAdj)
    assert adj.k == 128 and adj.comm_rows_per_device > 0
    assert adj.d_blk.shape == (adj.m_max, 128)


@pytest.mark.parametrize("hot_k", [None, 128], ids=["halo", "hybrid128"])
def test_gradients_exact(hot_k):
    g, jg = graphs(seed=3)
    rows = np.flatnonzero(g.train_mask)
    x = np.random.default_rng(5).standard_normal((g.n_nodes, 8)).astype(np.float32)
    cot = np.random.default_rng(6).standard_normal((len(rows), 8)).astype(np.float32)
    ct = np.zeros((g.n_nodes, 8), np.float32)
    ct[rows] = cot
    full = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    xt = torch.from_numpy(x).requires_grad_()
    (spmm_segment(full, xt)[torch.from_numpy(rows)] * torch.from_numpy(cot)).sum().backward()
    got = backward(rank_adjs(g, rows, 8, hot_k=hot_k), torch.from_numpy(ct)).numpy()
    np.testing.assert_allclose(got, xt.grad.numpy(), **TOL)
    jadj = jax_build(jg, rows, jax_make_mesh(8), hot_k=hot_k)
    rows_j = jnp.asarray(rows)
    want = jax.jit(jax.grad(lambda v: jnp.sum(jax_spmm(jadj, v)[rows_j] * jnp.asarray(cot))))(
        jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_auto_k_is_the_h100_chooser_s(monkeypatch):
    from pytextgcn_tpu_torch.parallel import restricted_sharded

    g, _ = graphs(n_vocab=1500, n_docs=1200, n_edges=30000, seed=8)
    rows = np.flatnonzero(g.train_mask)
    mesh = Mesh(None, 1, 4, CPU)
    in_rows = np.zeros(g.n_nodes, bool)
    in_rows[rows] = True
    r_src = np.asarray(g.edge_src, np.int64)[in_rows[np.asarray(g.edge_dst)]]
    want = choose_restricted_k(r_src, g.n_nodes, len(rows), h=43)
    adj = build_restricted_sharded_adj(g, rows, mesh, hot_k="auto", h_hint=43)
    if want:
        assert isinstance(adj, RestrictedShardedAdj) and adj.k == want
    else:
        assert isinstance(adj, HaloAdj)
    seen = []

    def chooser(src, n, m, h, itemsize):
        seen.append((len(src), n, m, h, itemsize))
        return 512

    monkeypatch.setattr(restricted_sharded, "choose_restricted_k", chooser)
    adj = build_restricted_sharded_adj(g, rows, mesh, hot_k="auto", h_hint=43,
                                       compute_dtype="bfloat16")
    assert isinstance(adj, RestrictedShardedAdj) and adj.k == 512
    assert seen == [(len(r_src), g.n_nodes, len(rows), 43, 2)]


@pytest.mark.parametrize("hot_k", [None, 128], ids=["halo", "hybrid128"])
def test_replicated_head_of_one_rank_through_autograd(hot_k):
    # the 'allgather' wrapper on a group of one: this rank's rows in, the
    # rows gathered out, through the real autograd functions
    g, _ = graphs(seed=9)
    rows = np.flatnonzero(g.train_mask)
    head = ReplicatedHead(build_restricted_sharded_adj(g, rows, Mesh(None, 0, 1, CPU),
                                                       hot_k=hot_k))
    x = np.random.default_rng(1).standard_normal((g.n_nodes, 6)).astype(np.float32)
    ct = np.random.default_rng(2).standard_normal((g.n_nodes, 6)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_()
    out = spmm(head, xt)
    (out * torch.from_numpy(ct)).sum().backward()
    sel = torch.zeros(g.n_nodes, 1)
    sel[rows] = 1.0
    full = NormAdj.from_graph(g, use_pallas=False, device="cpu")
    xr = torch.from_numpy(x).requires_grad_()
    ref = spmm_segment(full, xr) * sel
    (ref * torch.from_numpy(ct)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(), **TOL)
    np.testing.assert_allclose(xt.grad.numpy(), xr.grad.numpy(), **TOL)
