"""The split and bf16 dual kernels' operands on the CPU: the prologue's
padded bf16 planes (ops/fused_dual.py::operand_planes, the plain twin of
fused_dual_prologue in csrc/fused_dual.cu) and the plain products the
kernels are held to, against the JAX package's split_bf16 and its Pallas
kernels run in interpret mode, on shapes off the kernel's tiles (N on no
128-row slab, K on no 32-column tile).

Bands, relative to |D| @ |x| (dual_abs): the split within 3e-5 of the JAX
split kernel (the split2 class: the dropped lo*lo term is ~2^-18); bf16
within 1e-5 of the JAX bf16 kernel on the same bf16 operands (products of
bf16 values are exact in f32, only the order of the f32 sums differs) and
within 2^-7 of the f32 product (D and x each rounded to bf16)."""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytextgcn_tpu.ops import fused_dual as jfd
from pytextgcn_tpu_torch.ops import fused_dual as fd
from pytextgcn_tpu_torch.ops import spmm_cuda

SPLIT2_BAND = 3e-5
BF16_SAME_OPERANDS_BAND = 1e-5
BF16_BAND = 2.0**-7


def _bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _values(seed, rows, h):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((rows, h)) * 10.0 ** rng.integers(-5, 5, (rows, h))
    a[0, 0] = 1.0 + 2.0**-9  # no bf16 value: lo carries 2^-9
    return a.astype(np.float32)


@pytest.mark.parametrize("h", [1, 19, 43, 100, 130])
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16], ids=["split", "bf16"])
def test_operand_planes_equal_jax_split_bit_for_bit(variant, h):
    a = _values(h, 37, h)
    src = torch.from_numpy(a)
    planes = fd.operand_planes(variant, src if variant == fd.SPLIT else src.bfloat16())
    hp = fd.pad_width(h)
    assert hp % 8 == 0 and h <= hp < h + 8
    assert planes.dtype == torch.bfloat16
    assert planes.shape == (2 if variant == fd.SPLIT else 1, 37, hp)
    if variant == fd.SPLIT:
        want = jfd.split_bf16(jnp.asarray(a))
    else:
        want = (jnp.asarray(a, jnp.bfloat16),)
    for plane, half in zip(planes, want):
        np.testing.assert_array_equal(_bits(plane[:, :h]), _bits(half))
    # every row starts on 16 bytes and the padding is zeros, bit for bit
    assert not _bits(planes[:, :, h:]).any()
    if variant == fd.SPLIT:
        assert float(planes[1, 0, 0]) == 2.0**-9


# (N, K, H): N on no 128-row slab, K on no 32-column tile
RAGGED = [(333, 100, 43), (1001, 200, 19), (130, 45, 100)]


def _operands(seed, n, k, h):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((n, h)).astype(np.float32),
            rng.standard_normal((k, h)).astype(np.float32))


def _jax_dual(variant, d, x, xh):
    """The JAX Pallas kernel in interpret mode on D and xh zero-padded to a
    K of 128 multiples (its kernels take 128-aligned K; zero columns of D
    change neither product), hot sliced back to K rows."""
    k = d.shape[1]
    kp = -(-k // 128) * 128
    dp = np.pad(d, ((0, 0), (0, kp - k)))
    xhp = np.pad(xh, ((0, kp - k), (0, 0)))
    if variant == fd.SPLIT:
        hi, lo = jfd.split_bf16(jnp.asarray(dp))
        run = functools.partial(jfd.fused_dual_split, bn=256, bk=128, interpret=True)
        out, hot = jax.jit(run)(hi, lo, x, xhp)
    else:
        run = functools.partial(jfd.fused_dual, bn=256, bk=128, interpret=True)
        out, hot = jax.jit(run)(jnp.asarray(dp, jnp.bfloat16), x, xhp)
    return np.asarray(out), np.asarray(hot)[:k]


@pytest.mark.parametrize("shape", RAGGED, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16], ids=["split", "bf16"])
def test_plain_products_of_the_planes_match_jax_kernels(variant, shape):
    n, k, h = shape
    d, x, xh = _operands(sum(shape), n, k, h)
    td, tx, txh = (torch.from_numpy(a) for a in (d, x, xh))
    if variant == fd.SPLIT:
        ops = (*fd.split_bf16(td), tx, txh)
    else:
        ops = (td.bfloat16(), None, tx.bfloat16(), txh.bfloat16())
    out, hot = fd.dual_reference(variant, *ops)
    mag_out, mag_hot = (m.numpy() for m in fd.dual_abs(variant, *ops))

    # the products the kernel forms from the prologue's planes, in f64
    xp = fd.operand_planes(variant, ops[2])[:, :, :h].double()
    xhp = fd.operand_planes(variant, ops[3])[:, :, :h].double()
    dpl = [ops[0].double()] + ([ops[1].double()] if variant == fd.SPLIT else [])
    if variant == fd.SPLIT:
        want_out = dpl[0] @ xhp[0] + dpl[0] @ xhp[1] + dpl[1] @ xhp[0]
        want_hot = dpl[0].t() @ xp[0] + dpl[0].t() @ xp[1] + dpl[1].t() @ xp[0]
    else:
        want_out, want_hot = dpl[0] @ xhp[0], dpl[0].t() @ xp[0]
    for got, want, mag in ((out, want_out, mag_out), (hot, want_hot, mag_hot)):
        assert np.max(np.abs(got.numpy() - want.numpy()) / (mag + 1e-30)) < 1e-6

    jout, jhot = _jax_dual(variant, d, x, xh)
    band = SPLIT2_BAND if variant == fd.SPLIT else BF16_SAME_OPERANDS_BAND
    for got, want, mag in ((out, jout, mag_out), (hot, jhot, mag_hot)):
        assert got.shape == want.shape
        assert np.max(np.abs(got.numpy() - want) / (mag + 1e-30)) < band
    # and against the f64 product of the f32 operands
    d64 = d.astype(np.float64)
    for got, ref, mag in ((out, d64 @ xh, np.abs(d64) @ np.abs(xh)),
                          (hot, d64.T @ x, np.abs(d64).T @ np.abs(x))):
        rel = np.max(np.abs(got.numpy() - ref) / (mag + 1e-30))
        assert rel < (SPLIT2_BAND if variant == fd.SPLIT else BF16_BAND)


@pytest.mark.parametrize("lib, symbol", [
    (fd.fused_dual_kernel.lib, "fused_dual_launch"),
    (fd.fused_dual_kernel.lib, "fused_dual_prologue"),
    (spmm_cuda.spmm_csr_kernel.lib, "spmm_csr_launch"),
], ids=["fused_dual_launch", "fused_dual_prologue", "spmm_csr_launch"])
def test_ctypes_binding_matches_the_c_entry_point(lib, symbol):
    """Each C entry point the port calls is bound with as many ctypes
    arguments as its source declares (a mismatch would pass garbage to the
    kernel); the library's default symbol is its launch function."""
    with open(lib.src) as f:
        params = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', f.read()).group(1)
    assert len(lib.argtypes[symbol]) == len(params.split(","))
    assert lib.symbol == os.path.splitext(os.path.basename(lib.src))[0] + "_launch"
