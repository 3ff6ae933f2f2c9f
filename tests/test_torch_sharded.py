"""The port's all-gather partition (pytextgcn_tpu_torch/parallel/sharded.py)
against the JAX package's (pytextgcn_tpu/parallel/sharded.py).

One process plays every rank: each rank's ``ShardedAdj`` is built with a
``Mesh`` of no group, and its local math (output rows; its part of the
cotangent) is concatenated or summed as the collectives would. The arrays
must equal JAX's ``build_sharded_adj(use_pallas=False)`` ones at the
rank's index bit for bit; the products and gradients, JAX's within 1e-5
(each shard sums its rows' edges in the full plan's order, but the
cotangent's partial sums meet in another order). The JAX Pallas path runs
in interpret mode, as tests/test_sharded_pallas.py runs it."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
from pytextgcn_tpu.ops.spmm import spmm as jax_spmm
from pytextgcn_tpu.parallel import build_sharded_adj as jax_build_sharded_adj
from pytextgcn_tpu.parallel import make_mesh as jax_make_mesh
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.parallel import Mesh, ShardedAdj, build_sharded_adj
from pytextgcn_tpu_torch.parallel.sharded import (
    local_block,
    put_global,
    sharded_local_cotangent,
    sharded_local_rows,
)

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def graphs(seed=0, n_vocab=120, n_docs=130, n_edges=3000, dst_below=None):
    """The same graph for both packages; ``dst_below``: every edge lands in
    the first rows (the later shards hold none)."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    arrays = dict(
        edge_src=rng.integers(0, n, n_edges).astype(np.int32),
        edge_dst=rng.integers(0, dst_below or n, n_edges).astype(np.int32),
        edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
        y=rng.integers(0, 5, n).astype(np.int32),
        train_mask=np.zeros(n, bool), val_mask=np.zeros(n, bool),
        test_mask=np.zeros(n, bool), n_vocab=n_vocab, n_docs=n_docs,
    )
    return TextGraph(**arrays), JaxTextGraph(**arrays)


def rank_adjs(g, d, **kw):
    return [build_sharded_adj(g, Mesh(None, r, d, CPU), **kw) for r in range(d)]


def port_spmm(adjs, x):
    """``A_hat @ x`` from every rank's local rows, gathered as all_gather does."""
    a = adjs[0]
    rows = torch.cat([sharded_local_rows(adj, x) for adj in adjs])[:a.n_nodes]
    return rows + a.self_w[:, None] * x


def port_grad(adjs, ct):
    """The cotangent of x: every rank's part of it summed, as all_reduce does."""
    parts = [sharded_local_cotangent(adj, local_block(adj.mesh, ct, adj.rows_per))
             for adj in adjs]
    return torch.stack(parts).sum(0) + adjs[0].self_w[:, None] * ct


@pytest.mark.parametrize("d", [2, 4, 8])
def test_rank_arrays_equal_jax_bit_for_bit(d):
    g, jg = graphs(seed=d)
    jadj = jax_build_sharded_adj(jg, jax_make_mesh(d), use_pallas=False)
    for r, adj in enumerate(rank_adjs(g, d)):
        assert isinstance(adj, ShardedAdj) and adj.rows_per == jadj.rows_per
        for name in ("src", "dst_local", "w"):
            got, want = getattr(adj, name).numpy(), np.asarray(getattr(jadj, name))[r]
            assert got.dtype == want.dtype and np.array_equal(got, want), name
        assert np.array_equal(adj.self_w.numpy(), np.asarray(jadj.self_w))
        assert adj.n_edges == int((np.asarray(jadj.w)[r] != 0).sum())


@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
@pytest.mark.parametrize("jax_pallas", [False, True], ids=["jax_segment", "jax_pallas"])
def test_local_math_equals_jax_spmm_sharded_and_its_gradient(use_pallas, jax_pallas):
    d = 4
    g, jg = graphs(seed=11, n_vocab=200, n_docs=220, n_edges=3000)
    jadj = jax_build_sharded_adj(jg, jax_make_mesh(d), use_pallas=jax_pallas)
    adjs = rank_adjs(g, d, use_pallas=use_pallas)
    assert all((a.plan_fwd is not None) == use_pallas for a in adjs)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((g.n_nodes, 16)).astype(np.float32)
    ct = rng.standard_normal((g.n_nodes, 16)).astype(np.float32)
    want = jax.jit(jax_spmm)(jadj, jnp.asarray(x))
    got = port_spmm(adjs, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    jgrad = jax.grad(lambda v: jnp.vdot(jax_spmm(jadj, v), jnp.asarray(ct)))(jnp.asarray(x))
    np.testing.assert_allclose(port_grad(adjs, torch.from_numpy(ct)).numpy(),
                               np.asarray(jgrad), rtol=1e-5, atol=1e-5)


def test_plain_and_plan_paths_give_the_same_rows_bit_for_bit():
    # each shard's plan keeps the stable destination order of the full plan,
    # so the CSR path's rows equal the gather/index_add_ path's
    g, _ = graphs(seed=5)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((g.n_nodes, 8))
                         .astype(np.float32))
    plain, plan = rank_adjs(g, 4), rank_adjs(g, 4, use_pallas=True)
    assert torch.equal(port_spmm(plain, x), port_spmm(plan, x))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["segment", "csr"])
def test_empty_shards(use_pallas):
    # every edge lands in rows < 20: of 4 shards of 63 rows, 3 hold no edge
    d = 4
    g, jg = graphs(seed=2, n_vocab=120, n_docs=130, n_edges=500, dst_below=20)
    adjs = rank_adjs(g, d, use_pallas=use_pallas)
    assert [a.n_edges for a in adjs][1:] == [0, 0, 0] and adjs[0].n_edges == 500
    if use_pallas:
        assert adjs[3].plan_fwd.n_edges == 0 and adjs[3].plan_bwd.n_rows == g.n_nodes
    jadj = jax_build_sharded_adj(jg, jax_make_mesh(d), use_pallas=False)
    for r, adj in enumerate(adjs):
        assert np.array_equal(adj.w.numpy(), np.asarray(jadj.w)[r])
    rng = np.random.default_rng(4)
    x = rng.standard_normal((g.n_nodes, 5)).astype(np.float32)
    for adj in adjs[1:]:
        assert not sharded_local_rows(adj, torch.from_numpy(x)).any()
    np.testing.assert_allclose(port_spmm(adjs, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_spmm(jadj, jnp.asarray(x))), rtol=1e-5, atol=1e-5)
    jgrad = jax.grad(lambda v: jnp.sum(jax_spmm(jadj, v) ** 2))(jnp.asarray(x))
    ct = 2 * port_spmm(adjs, torch.from_numpy(x))
    np.testing.assert_allclose(port_grad(adjs, ct).numpy(), np.asarray(jgrad), rtol=1e-5,
                               atol=1e-5)


def test_bf16_shards_read_x_in_bf16():
    g, _ = graphs(seed=8)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((g.n_nodes, 8))
                         .astype(np.float32))
    f32 = port_spmm(rank_adjs(g, 2, use_pallas=True), x)
    bf16 = port_spmm(rank_adjs(g, 2, use_pallas=True, pallas_dtype="bfloat16"), x)
    assert bf16.dtype == torch.float32 and not torch.equal(bf16, f32)
    torch.testing.assert_close(bf16, f32, rtol=3e-2, atol=3e-2)


def test_put_global_is_the_rank_row_block():
    a = np.arange(24).reshape(8, 3)
    assert np.array_equal(put_global(Mesh(None, 2, 4, CPU), a).numpy(), a[4:6])
    with pytest.raises(ValueError, match="split"):
        put_global(Mesh(None, 0, 3, CPU), a)
