"""The port's halo exchange (pytextgcn_tpu_torch/parallel/halo.py) against
the JAX package's (pytextgcn_tpu/parallel/halo.py).

One process plays every rank: each rank's ``HaloAdj`` is built with a
``Mesh`` of no group, and the ring is simulated (at step s rank r receives
what rank (r-s-1) % D sent; in the backward each received block's
cotangent goes back to its sender). Every array must equal index ``rank``
of JAX's ``[D, ...]`` one bit for bit; the products and gradients, JAX's
``spmm_halo`` within 1e-5 (bf16 operands: 3e-2, as tests/test_halo.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.parallel import build_halo_adj as jax_build_halo_adj
from pytextgcn_tpu.parallel import make_mesh as jax_make_mesh
from pytextgcn_tpu.parallel.halo import spmm_halo as jax_spmm_halo
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.parallel import HaloAdj, Mesh, build_halo_adj
from pytextgcn_tpu_torch.parallel.halo import (
    halo_local_cotangents,
    halo_local_rows,
    halo_scatter_returned,
    halo_send_blocks,
)

CPU = torch.device("cpu")
ARRAYS = ("own_src", "own_dst", "own_w", "send_idx", "rem_pos", "rem_dst", "rem_w", "self_w")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def graphs(n_vocab=90, n_docs=110, n_edges=4000, seed=0, local_bias=False):
    """tests/test_halo.py's graphs, for both packages."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    src = rng.integers(0, n, n_edges).astype(np.int32)
    if local_bias:  # mostly-local edges: a partition with small halos
        dst = np.clip(src + rng.integers(-12, 13, n_edges), 0, n - 1).astype(np.int32)
    else:
        dst = rng.integers(0, n, n_edges).astype(np.int32)
    zeros = np.zeros(n, bool)
    tm = zeros.copy()
    tm[n_vocab:] = True
    arrays = dict(edge_src=src, edge_dst=dst,
                  edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
                  y=rng.integers(0, 3, n).astype(np.int32), train_mask=tm, val_mask=zeros,
                  test_mask=zeros, n_vocab=n_vocab, n_docs=n_docs)
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def rank_adjs(g, d, **kw):
    return [build_halo_adj(g, Mesh(None, r, d, CPU), **kw) for r in range(d)]


def ring_forward(adjs, x, cd=torch.float32):
    """Every rank's rows of ``A_hat @ x`` for ``x`` [N, H], ring simulated."""
    a, d = adjs[0], len(adjs)
    xp = torch.zeros(a.n_pad, x.shape[1])
    xp[:a.n_nodes] = x
    own = [xp[r * a.rows_per:(r + 1) * a.rows_per].to(cd) for r in range(d)]
    sends = [halo_send_blocks(adj, own[r]) for r, adj in enumerate(adjs)]
    out = []
    for r, adj in enumerate(adjs):
        recvs = [sends[(r - s - 1) % d][s] for s in range(d - 1)]
        self_term = (adj.self_w.to(cd)[:, None] * own[r]).float()
        out.append(halo_local_rows(adj, own[r], recvs, cd) + self_term)
    return torch.cat(out)[:a.n_nodes]


def ring_backward(adjs, ct, cd=torch.float32):
    """The cotangent of x from the output's ``ct`` [N, H], reverse ring."""
    a, d = adjs[0], len(adjs)
    cp = torch.zeros(a.n_pad, ct.shape[1])
    cp[:a.n_nodes] = ct
    gs = [cp[r * a.rows_per:(r + 1) * a.rows_per] for r in range(d)]
    local = [halo_local_cotangents(adj, gs[r], cd) for r, adj in enumerate(adjs)]
    out = []
    for r, adj in enumerate(adjs):
        returned = [local[(r + s + 1) % d][1][s] for s in range(d - 1)]
        gx = halo_scatter_returned(adj, local[r][0].clone(), returned)
        out.append(gx + (adj.self_w.to(cd)[:, None] * gs[r].to(cd)).float())
    return torch.cat(out)[:a.n_nodes]


@pytest.mark.parametrize("d", [2, 4, 8])
def test_rank_arrays_equal_jax_bit_for_bit(d):
    g, jg = graphs(seed=d)
    jadj = jax_build_halo_adj(jg, jax_make_mesh(d))
    for r, adj in enumerate(rank_adjs(g, d)):
        assert isinstance(adj, HaloAdj)
        assert (adj.rows_per, adj.n_pad, adj.n_shards) == (jadj.rows_per, jadj.n_pad, d)
        for name in ARRAYS:
            got, want = getattr(adj, name).numpy(), np.asarray(getattr(jadj, name))[r]
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert adj.comm_rows_per_device == jadj.comm_rows_per_device
        assert adj.row_block == (g.n_nodes, r * adj.rows_per)


def test_comm_volume_below_allgather():
    # tests/test_halo.py:71-81 on the same graph: the halo is a small
    # fraction of the (D-1) * rows_per rows the all-gather path moves
    g, jg = graphs(n_vocab=400, n_docs=400, n_edges=6000, seed=5, local_bias=True)
    adj = rank_adjs(g, 8)[0]
    assert adj.comm_rows_per_device == jax_build_halo_adj(jg, jax_make_mesh(8)).comm_rows_per_device
    assert adj.comm_rows_per_device < 0.6 * (8 - 1) * adj.rows_per


@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
@pytest.mark.parametrize("d", [2, 4, 8])
def test_local_math_equals_jax_spmm_halo_and_its_gradient(d, use_pallas):
    g, jg = graphs(seed=7 + d)
    jadj = jax_build_halo_adj(jg, jax_make_mesh(d))
    adjs = rank_adjs(g, d, use_pallas=use_pallas)
    assert all((a.plan_own is not None) == use_pallas for a in adjs)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    ct = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    want = jax.jit(jax_spmm_halo)(jadj, jnp.asarray(x))
    np.testing.assert_allclose(ring_forward(adjs, torch.from_numpy(x)).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-5)
    jgrad = jax.jit(jax.grad(lambda v: jnp.vdot(jax_spmm_halo(jadj, v), jnp.asarray(ct))))(
        jnp.asarray(x))
    np.testing.assert_allclose(ring_backward(adjs, torch.from_numpy(ct)).numpy(),
                               np.asarray(jgrad), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
def test_bf16_compute_dtype(use_pallas):
    # bf16 operands and wire, f32 accumulation: JAX's bf16 spmm_halo within
    # bf16 tolerance, forward and gradient
    g, jg = graphs(seed=13)
    jadj = jax_build_halo_adj(jg, jax_make_mesh(4))
    adjs = rank_adjs(g, 4, use_pallas=use_pallas, compute_dtype="bfloat16")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    ct = rng.standard_normal((g.n_nodes, 8)).astype(np.float32)
    bf = lambda a, v: jax_spmm_halo(a, v, compute_dtype="bfloat16")
    got = ring_forward(adjs, torch.from_numpy(x), torch.bfloat16)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.jit(bf)(jadj, jnp.asarray(x))),
                               rtol=3e-2, atol=3e-2)
    jgrad = jax.jit(jax.grad(lambda v: jnp.vdot(bf(jadj, v), jnp.asarray(ct))))(
        jnp.asarray(x))
    np.testing.assert_allclose(ring_backward(adjs, torch.from_numpy(ct), torch.bfloat16).numpy(),
                               np.asarray(jgrad), rtol=3e-2, atol=3e-2)


def test_one_rank_sends_nothing():
    g, jg = graphs(seed=1)
    adj = rank_adjs(g, 1, use_pallas=True)[0]
    jadj = jax_build_halo_adj(jg, jax_make_mesh(1))
    for name in ARRAYS:
        assert np.array_equal(getattr(adj, name).numpy(), np.asarray(getattr(jadj, name))[0])
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((g.n_nodes, 4))
                         .astype(np.float32))
    assert halo_send_blocks(adj, x) == [] and adj.plan_rem == []
    np.testing.assert_allclose(ring_forward([adj], x).numpy(),
                               np.asarray(jax_spmm_halo(jadj, jnp.asarray(x.numpy()))),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("explicit", [False, True], ids=["identity", "explicit_x"])
def test_row_block_features_are_the_rank_rows_with_zero_pads(explicit):
    # a halo rank's first-layer input: rows [lo, lo + rows_per) of X @ W,
    # rows past the last node zero; hierarchy columns on document rows
    from pytextgcn_tpu_torch.ops import NodeFeatures

    rng = np.random.default_rng(6)
    n_vocab, n_docs = 7, 10
    x = rng.standard_normal((n_vocab + n_docs, 5)).astype(np.float32) if explicit else None
    hier = None if explicit else rng.standard_normal((n_docs, 3)).astype(np.float32)
    feats = NodeFeatures(n_vocab, n_docs, x=None if x is None else torch.from_numpy(x),
                         hierarchy=None if hier is None else torch.from_numpy(hier))
    w = torch.from_numpy(rng.standard_normal((feats.in_dim, 4)).astype(np.float32))
    full = feats.matmul(w)
    rows_per = 5  # 4 ranks of 5 rows over 17 nodes: the last holds 2 and 3 pads
    blocks = [feats.row_block(r * rows_per, rows_per).matmul(w) for r in range(4)]
    assert all(b.shape == (rows_per, 4) for b in blocks)
    torch.testing.assert_close(torch.cat(blocks)[:17], full, rtol=1e-6, atol=1e-7)
    assert not blocks[3][2:].any()
