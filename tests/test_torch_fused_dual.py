"""Port dual product (ops/fused_dual.py: split_bf16, the plain versions
behind fused_dual / fused_dual_t / fused_dual_split, their autograd) against
the JAX package's Pallas kernels, run in interpret mode on the CPU as
tests/test_fused_dual.py runs them.

Tolerances: f32 and bf16 products rtol 1e-5 / atol 1e-4 (the JAX tests'
band: the two sum in different orders); the split within 2e-5 of the
largest output of an f64 oracle (the split2 class: the dropped lo*lo term
is ~2^-18 relative)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.ops import fused_dual as jfd
from pytextgcn_tpu_torch.ops import fused_dual as fd

RTOL, ATOL = 1e-5, 1e-4
SPLIT_BAND = 2e-5


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _inputs(seed, n, k, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((n, h)).astype(np.float32),
            rng.standard_normal((k, h)).astype(np.float32))


def test_split_bf16_is_bitwise_equal_to_jax():
    rng = np.random.default_rng(0)
    a = np.concatenate([rng.standard_normal(4000).astype(np.float32) * 10.0**rng.integers(
        -6, 6, 4000), np.float32([0.0, -0.0, 1.0, 1.0 + 2.0**-9, 6.5e4])])
    a = a.astype(np.float32)
    hi, lo = fd.split_bf16(torch.from_numpy(a))
    jhi, jlo = jfd.split_bf16(jnp.asarray(a))
    assert hi.dtype == lo.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(hi), _bits(jhi))
    np.testing.assert_array_equal(_bits(lo), _bits(jlo))
    # the lo half carries what hi dropped: 1 + 2^-9 is no bf16 value
    assert float(lo[-2]) == 2.0**-9 and (lo != 0).float().mean() > 0.9
    recon = hi.double() + lo.double()
    assert (recon - torch.from_numpy(a).double()).abs().max() <= 2.0**-16 * np.abs(a).max()


@pytest.mark.parametrize("h", [100, 43])
def test_split_matches_jax_and_f64_oracle(h):
    d, x, xh = _inputs(1, 512, 256, h)  # h < 128: the JAX kernel pads lanes
    dhi, dlo = fd.split_bf16(torch.from_numpy(d))
    out, hot = fd.fused_dual_split(dhi, dlo, torch.from_numpy(x), torch.from_numpy(xh))
    jhi, jlo = jfd.split_bf16(jnp.asarray(d))
    jout, jhot = jax.jit(functools.partial(jfd.fused_dual_split, bn=256, bk=256,
                                           interpret=True))(jhi, jlo, x, xh)
    assert out.dtype == hot.dtype == torch.float32
    assert out.shape == (512, h) and hot.shape == (256, h)
    ref_out = d.astype(np.float64) @ xh.astype(np.float64)
    ref_hot = d.astype(np.float64).T @ x.astype(np.float64)
    for got, want, ref in ((out.numpy(), jout, ref_out), (hot.numpy(), jhot, ref_hot)):
        scale = np.abs(ref).max()
        assert np.abs(got - ref).max() / scale < SPLIT_BAND
        assert np.abs(np.asarray(want) - ref).max() / scale < SPLIT_BAND
        np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)


def test_split_gradients_match_jax():
    d, x, xh = _inputs(2, 512, 256, 100)
    rng = np.random.default_rng(3)
    t_out = rng.standard_normal((512, 100)).astype(np.float32)
    t_hot = rng.standard_normal((256, 100)).astype(np.float32)
    dhi, dlo = fd.split_bf16(torch.from_numpy(d))
    xt = torch.from_numpy(x).requires_grad_(True)
    xht = torch.from_numpy(xh).requires_grad_(True)
    out, hot = fd.fused_dual_split(dhi, dlo, xt, xht)
    ((out * torch.from_numpy(t_out)).sum() + (hot * torch.from_numpy(t_hot)).sum()).backward()

    jhi, jlo = jfd.split_bf16(jnp.asarray(d))

    def f(x, xh):
        o, hh = jfd.fused_dual_split(jhi, jlo, x, xh, bn=256, bk=256, interpret=True)
        return jnp.sum(o * t_out) + jnp.sum(hh * t_hot)

    jgx, jgxh = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(xh))
    # analytic: g_x = D @ t_hot, g_xh = D^T @ t_out
    for got, want, ref in ((xt.grad, jgx, d.astype(np.float64) @ t_hot),
                           (xht.grad, jgxh, d.astype(np.float64).T @ t_out)):
        assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() < SPLIT_BAND
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["fused_dual", "fused_dual_t"])
def test_single_d_matches_jax(dtype, layout):
    d, x, xh = _inputs(4, 512, 256, 100)
    td = torch.from_numpy(d).to(getattr(torch, dtype))
    jd = jnp.asarray(d, jnp.dtype(dtype))
    assert np.array_equal(_bits(td) if dtype == "bfloat16" else td.numpy(),
                          _bits(jd) if dtype == "bfloat16" else np.asarray(jd))
    out, hot = getattr(fd, layout)(td, torch.from_numpy(x), torch.from_numpy(xh))
    bk = 256 if layout == "fused_dual" else 128  # the [H, K] hot in two K steps
    jout, jhot = jax.jit(functools.partial(getattr(jfd, layout), bn=256, bk=bk,
                                           interpret=True))(jd, x, xh)
    assert out.dtype == hot.dtype == torch.float32 and hot.shape == (256, 100)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hot.numpy(), np.asarray(jhot), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("layout", ["fused_dual", "fused_dual_t"])
def test_single_d_gradients_match_jax(layout):
    d, x, xh = _inputs(5, 512, 256, 64)
    rng = np.random.default_rng(6)
    t_out = rng.standard_normal((512, 64)).astype(np.float32)
    t_hot = rng.standard_normal((256, 64)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    xht = torch.from_numpy(xh).requires_grad_(True)
    out, hot = getattr(fd, layout)(torch.from_numpy(d), xt, xht)
    ((out * torch.from_numpy(t_out)).sum() + (hot * torch.from_numpy(t_hot)).sum()).backward()

    def f(x, xh):
        o, hh = getattr(jfd, layout)(jnp.asarray(d), x, xh, bn=256, bk=128, interpret=True)
        return jnp.sum(o * t_out) + jnp.sum(hh * t_hot)

    jgx, jgxh = jax.jit(jax.grad(f, argnums=(0, 1)))(jnp.asarray(x), jnp.asarray(xh))
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(xht.grad.numpy(), np.asarray(jgxh), rtol=RTOL, atol=ATOL)


def test_ragged_tiny_k_needs_no_fallback():
    # N, K and H multiples of no tile, K < 128: the JAX wrapper falls back
    # to XLA dots here; the port has one path for every shape
    d, x, xh = _inputs(7, 301, 37, 19)
    out, hot = fd.fused_dual(torch.from_numpy(d), torch.from_numpy(x), torch.from_numpy(xh))
    jout, jhot = jfd.fused_dual(jnp.asarray(d), jnp.asarray(x), jnp.asarray(xh),
                                interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hot.numpy(), np.asarray(jhot), rtol=RTOL, atol=ATOL)
    mag_out, mag_hot = fd.dual_abs(fd.F32, torch.from_numpy(d), None, torch.from_numpy(x),
                                   torch.from_numpy(xh))
    np.testing.assert_allclose(mag_out.numpy(), np.abs(d) @ np.abs(xh), rtol=1e-5)
    np.testing.assert_allclose(mag_hot.numpy(), np.abs(d).T @ np.abs(x), rtol=1e-5)


def test_kernel_wrapper_takes_cuda_tensors_only():
    d, x, xh = (torch.from_numpy(a) for a in _inputs(8, 64, 16, 8))
    before = dict(fd.fused_dual_kernel.launches)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd.fused_dual_kernel(fd.F32, d, None, x, xh)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fd.fused_dual(d.half(), x, xh)
    # the CPU path is the plain version: no launch is counted
    fd.fused_dual_split(*fd.split_bf16(d), x, xh)
    assert fd.fused_dual_kernel.launches == before
