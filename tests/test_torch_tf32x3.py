"""The f32 dual kernel's arithmetic (three TF32 passes) emulated on the CPU
(ops/fused_dual.py: split_tf32, dual_reference_tf32x3) against the JAX
package's f32 kernels at HIGHEST, run in interpret mode as
tests/test_fused_dual.py runs them, and against an f64 oracle.

Bands: the JAX tests' rtol 1e-5 / atol 1e-4 against JAX; within 2e-6 of the
f64 oracle's |D| @ |x| scale (three passes measure ~2.5e-7, plain f32
~3e-7, one TF32 pass ~1e-4, so the band tells them apart)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.ops import fused_dual as jfd
from pytextgcn_tpu_torch.core.graph import gcn_normalize_np
from pytextgcn_tpu_torch.ops import fused_dual as fd
from pytextgcn_tpu_torch.ops import hybrid

RTOL, ATOL = 1e-5, 1e-4
ORACLE_BAND = 2e-6


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int32).numpy()


def _samples() -> torch.Tensor:
    rng = np.random.default_rng(0)
    # normal f32 values whose small halves are normal too
    a = rng.standard_normal(20_000) * 10.0 ** rng.integers(-20, 20, 20_000)
    return torch.from_numpy(np.concatenate([a, -a, [0.0, -0.0, 1.0, -1.0, 3e38, 1e-30]])
                            .astype(np.float32))


def test_split_tf32_big_has_no_low_bits():
    big, small = fd.split_tf32(_samples())
    assert not (_bits(big) & 0x1FFF).any()
    assert not (_bits(small) & 0x1FFF).any()
    assert big.dtype == small.dtype == torch.float32


@pytest.mark.parametrize("a,want", [
    (1 + 2.0**-11, 1 + 2.0**-10),       # a tie: away from zero, where ties-to-even gives 1
    (-(1 + 2.0**-11), -(1 + 2.0**-10)),
    (1 + 3 * 2.0**-11, 1 + 2.0**-9),    # a tie that both rules round up
    (1 + 2.0**-11 + 2.0**-20, 1 + 2.0**-10),  # above the tie
    (1 + 2.0**-11 - 2.0**-20, 1.0),     # below it
    (2 - 2.0**-12, 2.0),                # rounds into the next binade
])
def test_split_tf32_rounds_to_nearest_ties_away(a, want):
    big, small = fd.split_tf32(torch.tensor([a], dtype=torch.float32))
    assert float(big) == want
    assert float(big) + float(small) == pytest.approx(a, rel=2.0**-22, abs=0)


def test_split_tf32_pair_carries_22_bits():
    a = _samples()
    big, small = fd.split_tf32(a)
    err = (big.double() + small.double() - a.double()).abs()
    assert (err <= 2.0**-22 * a.double().abs()).all()
    # small is nonzero wherever a is not a TF32 value
    assert ((small != 0) == (big != a)).all()
    zero = fd.split_tf32(torch.tensor([0.0, -0.0]))
    assert (zero[0] == 0).all() and (zero[1] == 0).all()


def _one_pass(d, x, xh):
    db, xb, xhb = (fd.split_tf32(t)[0] for t in (d, x, xh))
    return db @ xhb, db.t() @ xb


def _randn(seed, n, k, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((n, h)).astype(np.float32),
            rng.standard_normal((k, h)).astype(np.float32))


def _plan_d(seed, h):
    """The f32 D of a small hybrid plan (Zipfian graph stored in both
    directions, K = 128), padded to 512 rows for the JAX kernel's blocks."""
    rng = np.random.default_rng(seed)
    n = 500
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    a, b = rng.choice(n, 4000, p=p), rng.choice(n, 4000, p=p)
    w = (rng.random(4000) + 0.05).astype(np.float32)
    src, dst = np.r_[a, b].astype(np.int32), np.r_[b, a].astype(np.int32)
    wn, _ = gcn_normalize_np(src, dst, np.r_[w, w], n)
    plan = hybrid.build_hybrid_plan(src, dst, wn, n, hot_k=128, f32_mode="highest")
    d = np.zeros((512, plan.k), np.float32)
    d[:n] = plan.d_full.numpy()
    return d, rng.standard_normal((512, h)).astype(np.float32), \
        rng.standard_normal((plan.k, h)).astype(np.float32)


@pytest.mark.parametrize("layout", ["fused_dual", "fused_dual_t"])
@pytest.mark.parametrize("h", [100, 43])
@pytest.mark.parametrize("source", ["randn", "plan"])
def test_three_passes_match_jax_highest_and_oracle(source, h, layout):
    d, x, xh = _randn(3, 512, 256, h) if source == "randn" else _plan_d(4, h)
    k = d.shape[1]
    out, hot = fd.dual_reference_tf32x3(*(torch.from_numpy(a) for a in (d, x, xh)))
    bk = k if layout == "fused_dual" else 128  # the [H, K] hot in K steps of 128
    jout, jhot = jax.jit(functools.partial(getattr(jfd, layout), bn=256, bk=bk,
                                           interpret=True))(jnp.asarray(d), x, xh)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(hot.numpy(), np.asarray(jhot), rtol=RTOL, atol=ATOL)
    d64 = d.astype(np.float64)
    one_out, one_hot = _one_pass(*(torch.from_numpy(a) for a in (d, x, xh)))
    for got, one, ref, scale in ((out, one_out, d64 @ xh, np.abs(d64) @ np.abs(xh)),
                                 (hot, one_hot, d64.T @ x, np.abs(d64).T @ np.abs(x))):
        scale = np.maximum(scale, 1e-30)
        assert np.max(np.abs(got.numpy() - ref) / scale) <= ORACLE_BAND
        # one TF32 pass fails the same band on the same inputs
        assert np.max(np.abs(one.numpy() - ref) / scale) > 10 * ORACLE_BAND


def test_emulation_is_the_plain_product_of_the_halves():
    d, x, xh = (torch.from_numpy(a) for a in _randn(5, 64, 48, 16))
    db, ds = fd.split_tf32(d)
    xhb, xhs = fd.split_tf32(xh)
    out, _ = fd.dual_reference_tf32x3(d, x, xh)
    want = db.double() @ xhb.double() + db.double() @ xhs.double() + ds.double() @ xhb.double()
    # every product of two TF32 values is exact in f32: only the sums round
    assert (out.double() - want).abs().max() <= 1e-6 * (d.abs() @ xh.abs()).max()
