"""The CUDA kernels (the CSR SpMM, the dual product) against their plain
versions, on the card.

Marked ``gpu``: each test skips, with its reason, when no CUDA device is
present (decided in the fixture, at run time). On a machine with the card
and without JAX (tests/conftest.py imports it, so it is skipped and the
marker registered on the command line):
``python -m pytest --noconftest -o "markers=gpu: needs a CUDA device"
tests/test_torch_kernels_gpu.py -q``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.models import GCN
from pytextgcn_tpu_torch.ops import NormAdj, NodeFeatures
from pytextgcn_tpu_torch.ops import spmm_cuda

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _assert_close(got, want, scale, rtol=1e-5, atol=1e-6):
    """``|got - want| <= atol + rtol * scale`` with ``scale`` the sum of the
    terms' magnitudes (``spmm_csr_abs``): kernel and plain version sum in
    different orders, which moves a result that cancels to near zero by a
    multiple of eps times that sum, not of the result."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    diff = (got.float() - want.float()).abs()
    worst = float((diff / (atol + scale)).max())
    assert (diff <= atol + rtol * scale).all(), f"max err/scale {worst:.2e} > {rtol:g}"


def _plan(rng, n, e, device, hubs=False, dtype="float32"):
    if hubs:  # a few rows far longer than a segment, most rows empty
        src = rng.integers(0, n, e)
        dst = np.concatenate([rng.integers(0, 3, e - e // 10), rng.integers(0, n, e // 10)])
    else:
        src, dst = rng.integers(0, n, e), rng.integers(0, n, e)
    w = rng.random(e).astype(np.float32)
    return spmm_cuda.build_plan_from_arrays(src, dst, w, n, compute_dtype=dtype,
                                            device=device)


@pytest.mark.parametrize("h", [100, 43, 4, 1, 70, 97, 130])
@pytest.mark.parametrize("hubs", [False, True], ids=["uniform", "hubs"])
def test_kernel_matches_plain_f32(cuda, h, hubs):
    rng = np.random.default_rng(h)
    plan = _plan(rng, 3000, 40_000, cuda, hubs=hubs)
    x = torch.randn(3000, h, device=cuda)
    for csr in (plan.fwd, plan.bwd):
        got = spmm_cuda.spmm_csr_kernel(csr, x)
        want = spmm_cuda.spmm_csr_reference(csr, x)
        torch.cuda.synchronize()
        _assert_close(got, want, spmm_cuda.spmm_csr_abs(csr, x))
    # deterministic: no atomics
    assert torch.equal(spmm_cuda.spmm_csr_kernel(plan.fwd, x),
                       spmm_cuda.spmm_csr_kernel(plan.fwd, x))


@pytest.mark.parametrize("h", [100, 43])
def test_kernel_matches_plain_bf16(cuda, h):
    rng = np.random.default_rng(7)
    plan = _plan(rng, 3000, 40_000, cuda, hubs=True)
    x32 = torch.randn(3000, h, device=cuda)
    x = x32.bfloat16()
    got = spmm_cuda.spmm_csr_kernel(plan.fwd, x)
    want = spmm_cuda.spmm_csr_reference(plan.fwd, x)  # same bf16 inputs, f32 sums
    assert got.dtype == torch.float32
    _assert_close(got, want, spmm_cuda.spmm_csr_abs(plan.fwd, x))
    # against the f32 x: bf16 rounds each x by at most 2^-9 of its magnitude
    _assert_close(got, spmm_cuda.spmm_csr_reference(plan.fwd, x32),
                  spmm_cuda.spmm_csr_abs(plan.fwd, x32), rtol=2.0**-8)


def test_gradient_through_autograd_function(cuda):
    rng = np.random.default_rng(3)
    plan = _plan(rng, 2000, 30_000, cuda, hubs=True)
    x = torch.randn(2000, 43, device=cuda, requires_grad=True)
    g = torch.randn(2000, 43, device=cuda)
    before = spmm_cuda.spmm_csr_kernel.launches
    (spmm_cuda.spmm_plan(plan, x) * g).sum().backward()
    assert spmm_cuda.spmm_csr_kernel.launches == before + 2
    _assert_close(x.grad, spmm_cuda.spmm_csr_reference(plan.bwd, g),
                  spmm_cuda.spmm_csr_abs(plan.bwd, g))


def test_isolated_nodes_and_empty_graph(cuda):
    n = 50
    src = np.array([0, 1, 2, 2], np.int32)
    dst = np.array([1, 0, 3, 0], np.int32)
    plan = spmm_cuda.build_plan_from_arrays(src, dst, np.ones(4, np.float32), n,
                                            device=cuda)
    x = torch.randn(n, 8, device=cuda)
    out = spmm_cuda.spmm_csr_kernel(plan.fwd, x)
    assert not out[4:].any() and not out[2].any()  # exact zeros, not garbage
    _assert_close(out, spmm_cuda.spmm_csr_reference(plan.fwd, x),
                  spmm_cuda.spmm_csr_abs(plan.fwd, x))
    empty = spmm_cuda.build_plan_from_arrays(np.zeros(0), np.zeros(0), np.zeros(0), n,
                                             device=cuda)
    assert not spmm_cuda.spmm_csr_kernel(empty.fwd, x).any()


def test_wrapper_rejects_bad_inputs(cuda):
    plan = _plan(np.random.default_rng(0), 100, 500, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        spmm_cuda.spmm_csr_kernel(plan.fwd, torch.randn(8, 100, device=cuda).t())
    with pytest.raises(ValueError, match=r"\[100, H\]"):
        spmm_cuda.spmm_csr_kernel(plan.fwd, torch.randn(99, 8, device=cuda))
    with pytest.raises(TypeError):
        spmm_cuda.spmm_csr_kernel(plan.fwd, torch.randn(100, 8, device=cuda).half())


def test_gcn_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(5)
    n_vocab, n_docs, e = 300, 400, 8000
    n = n_vocab + n_docs
    g = TextGraph(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_w=rng.random(e).astype(np.float32), y=rng.integers(0, 5, n).astype(np.int32),
        train_mask=np.r_[np.zeros(n_vocab, bool), np.ones(n_docs, bool)],
        val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n_vocab, n_docs=n_docs)
    model = GCN(n, 5, n_hidden_gcn=100, dropout=0.0, generator=torch.Generator().manual_seed(0))
    cpu = model(NormAdj.from_graph(g, use_pallas=True, device="cpu"),
                NodeFeatures.from_graph(g, device="cpu"))
    model.to(cuda)
    gpu = model(NormAdj.from_graph(g, use_pallas=True, device=cuda),
                NodeFeatures.from_graph(g, device=cuda))
    torch.testing.assert_close(gpu.cpu(), cpu, rtol=1e-5, atol=1e-5)


# ------------------------------------------------- the dual kernel (fused_dual.cu)

from pytextgcn_tpu_torch.ops import fused_dual as fd  # noqa: E402
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment  # noqa: E402

DUAL_SHAPES = [(3000, 512, 100), (3000, 512, 43), (1001, 100, 19), (777, 200, 130),
               (129, 7, 1)]


def _dual_operands(variant, n, k, h, device, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    d = torch.randn(n, k, generator=gen, device=device)
    x = torch.randn(n, h, generator=gen, device=device)
    xh = torch.randn(k, h, generator=gen, device=device)
    if variant == fd.SPLIT:
        return (*fd.split_bf16(d), x, xh)
    if variant == fd.BF16:
        return d.bfloat16(), None, x.bfloat16(), xh.bfloat16()
    return d, None, x, xh


@pytest.mark.parametrize("hot_t", [False, True], ids=["hot_KH", "hot_HK"])
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16, fd.F32], ids=["split", "bf16", "f32"])
@pytest.mark.parametrize("shape", DUAL_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_dual_kernel_matches_plain(cuda, shape, variant, hot_t):
    d, d_lo, x, xh = _dual_operands(variant, *shape, cuda)
    before = fd.fused_dual_kernel.launches.get(fd.VARIANT_NAMES[variant] + "_t" * hot_t, 0)
    out, hot = fd.fused_dual_kernel(variant, d, d_lo, x, xh, hot_t=hot_t)
    torch.cuda.synchronize()
    assert fd.fused_dual_kernel.launches[fd.VARIANT_NAMES[variant] + "_t" * hot_t] == before + 1
    n, k, h = shape
    assert out.shape == (n, h) and hot.shape == ((h, k) if hot_t else (k, h))
    hot = hot.t() if hot_t else hot
    want_out, want_hot = fd.dual_reference(variant, d, d_lo, x, xh)
    mag_out, mag_hot = fd.dual_abs(variant, d, d_lo, x, xh)
    # the kernel and the plain version sum in different orders (hot with
    # atomics, in an order that changes from run to run)
    _assert_close(out, want_out, mag_out)
    _assert_close(hot, want_hot, mag_hot)


@pytest.mark.parametrize("shape", DUAL_SHAPES[:3], ids=lambda s: "x".join(map(str, s)))
def test_dual_kernel_bf16_against_f32_inputs(cuda, shape):
    d, _, x, xh = _dual_operands(fd.F32, *shape, cuda)
    out, hot = fd.fused_dual(d.bfloat16(), x, xh)
    want_out, want_hot = fd.dual_reference(fd.F32, d, None, x, xh)
    mag_out, mag_hot = fd.dual_abs(fd.F32, d, None, x, xh)
    _assert_close(out, want_out, mag_out, rtol=2.0**-7)  # D and x each rounded to bf16
    _assert_close(hot, want_hot, mag_hot, rtol=2.0**-7)
    # split: within the split2 band of the f32 products
    out, hot = fd.fused_dual_split(*fd.split_bf16(d), x, xh)
    _assert_close(out, want_out, mag_out, rtol=2e-5)
    _assert_close(hot, want_hot, mag_hot, rtol=2e-5)


@pytest.mark.parametrize("layout", ["fused_dual_split", "fused_dual", "fused_dual_t"])
def test_dual_autograd_backward_is_the_kernel(cuda, layout):
    d, _, x0, xh0 = _dual_operands(fd.F32, 2000, 384, 100, cuda, seed=3)
    x = x0.clone().requires_grad_(True)
    xh = xh0.clone().requires_grad_(True)
    gen = torch.Generator(device=cuda).manual_seed(4)
    g_out = torch.randn(2000, 100, generator=gen, device=cuda)
    g_hot = torch.randn(384, 100, generator=gen, device=cuda)
    operands = (*fd.split_bf16(d),) if layout == "fused_dual_split" else (d,)
    before = sum(fd.fused_dual_kernel.launches.values())
    out, hot = getattr(fd, layout)(*operands, x, xh)
    ((out * g_out).sum() + (hot * g_hot).sum()).backward()
    assert sum(fd.fused_dual_kernel.launches.values()) == before + 2
    variant = fd.SPLIT if layout == "fused_dual_split" else fd.F32
    d_lo = operands[1] if variant == fd.SPLIT else None
    want_gx, want_gxh = fd.dual_reference(variant, operands[0], d_lo, g_out, g_hot)
    mag_gx, mag_gxh = fd.dual_abs(variant, operands[0], d_lo, g_out, g_hot)
    _assert_close(x.grad, want_gx, mag_gx)
    _assert_close(xh.grad, want_gxh, mag_gxh)


def test_dual_wrapper_rejects_bad_inputs(cuda):
    d, _, x, xh = _dual_operands(fd.F32, 64, 16, 8, cuda)
    with pytest.raises(TypeError, match="bfloat16"):
        fd.fused_dual_kernel(fd.BF16, d, None, x, xh)
    with pytest.raises(ValueError, match="contiguous"):
        fd.fused_dual_kernel(fd.F32, d, None, x.t().contiguous().t(), xh)
    with pytest.raises(ValueError, match=r"\[64, H\]"):
        fd.fused_dual_kernel(fd.F32, d, None, x[:60].contiguous(), xh)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd.fused_dual_kernel(fd.F32, d, None, x.cpu(), xh)


def _symmetric_graph(rng, n_vocab=700, n_docs=1300, n_edges=60_000):
    n = n_vocab + n_docs
    p = 1.0 / np.arange(1, n + 1) ** 1.1
    p /= p.sum()
    a, b = rng.choice(n, n_edges // 2, p=p), rng.choice(n, n_edges // 2, p=p)
    w = (rng.random(n_edges // 2) + 0.05).astype(np.float32)
    return TextGraph(
        edge_src=np.r_[a, b].astype(np.int32), edge_dst=np.r_[b, a].astype(np.int32),
        edge_w=np.r_[w, w], y=np.zeros(n, np.int32), train_mask=np.zeros(n, bool),
        val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n_vocab, n_docs=n_docs, weight_symmetric=True)


@pytest.mark.parametrize("mode,kw,rtol", [
    ("split2", {}, 3e-5),
    ("highest", dict(hybrid_f32_mode="highest"), 1e-5),
    ("highest_fused", dict(hybrid_f32_mode="highest", hybrid_fused=True), 1e-5),
    # bf16: D, x and, in the backward pass, the gradient are each rounded
    # to bf16 (relative error <= 2^-9 apiece)
    ("bf16", dict(pallas_dtype="bfloat16"), 2.0**-6),
])
@pytest.mark.parametrize("h", [100, 43])
def test_hybrid_spmm_on_card_matches_segment(cuda, mode, kw, rtol, h):
    g = _symmetric_graph(np.random.default_rng(h))
    adj = NormAdj.from_graph(g, hybrid_k=256, device=cuda, **kw)
    seg = NormAdj.from_graph(g, device=cuda)
    x = torch.randn(g.n_nodes, h, device=cuda, requires_grad=True)
    xs = x.detach().clone().requires_grad_(True)
    ct = torch.randn(g.n_nodes, h, device=cuda)
    dual_before = sum(fd.fused_dual_kernel.launches.values())
    csr_before = spmm_cuda.spmm_csr_kernel.launches
    out = spmm(adj, x)
    (out * ct).sum().backward()
    dual = sum(fd.fused_dual_kernel.launches.values()) - dual_before
    assert dual == (0 if mode == "highest" else 2)  # 'highest' unfused: two torch.mm
    assert spmm_cuda.spmm_csr_kernel.launches - csr_before == 2
    want = spmm_segment(seg, xs)
    (want * ct).sum().backward()
    with torch.no_grad():
        scale_out = spmm_segment(dataclasses.replace(seg, w=seg.w.abs()), x.abs())
        scale_grad = spmm_segment(dataclasses.replace(seg, w=seg.w.abs()), ct.abs())
    _assert_close(out.detach(), want.detach(), scale_out, rtol=rtol)
    _assert_close(x.grad, xs.grad, scale_grad, rtol=rtol)
