"""The CUDA kernels (the CSR SpMM, the dual product, Adam) against their
plain versions, on the card.

Marked ``gpu``: each test skips, with its reason, when no CUDA device is
present (decided in the fixture, at run time). On a machine with the card
and without JAX (tests/conftest.py imports it, so it is skipped and the
marker registered on the command line):
``python -m pytest --noconftest -o "markers=gpu: needs a CUDA device"
tests/test_torch_kernels_gpu.py -q``.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.models import GCN
from pytextgcn_tpu_torch.ops import NormAdj, NodeFeatures
from pytextgcn_tpu_torch.ops import spmm_cuda
from pytextgcn_tpu_torch.train.optim import Adam

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


# the hierarchy and model paths' widths: per-label members' child counts
# (2, 7, 9), the amazon Cat1 level (6), the dbpedia hidden width and levels
# (32, 9, 219: a row of 55 vectors, one group a warp, two 128-column blocks)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [2, 6, 7, 9, 32, 219])
@pytest.mark.parametrize("hubs", [False, True], ids=["uniform", "hubs"])
def test_kernel_matches_plain_at_hierarchy_widths(cuda, h, hubs, dtype):
    rng = np.random.default_rng(1000 + h)
    plan = _plan(rng, 3000, 40_000, cuda, hubs=hubs)
    x32 = torch.randn(3000, h, device=cuda)
    x = x32.to(dtype)
    for csr in (plan.fwd, plan.bwd):
        before = spmm_cuda.spmm_csr_kernel.launches
        got = spmm_cuda.spmm_csr_kernel(csr, x)
        assert spmm_cuda.spmm_csr_kernel.launches == before + 1
        assert got.shape == (3000, h) and got.dtype == torch.float32
        _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))
        if dtype == torch.bfloat16:  # bf16 rounds each x by at most 2^-9 of it
            _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x32),
                          spmm_cuda.spmm_csr_abs(csr, x32), rtol=2.0**-8)
        assert torch.equal(got, spmm_cuda.spmm_csr_kernel(csr, x))  # no atomics


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


@pytest.mark.parametrize("name", ["egcn", "jk"])
def test_models_on_card_match_cpu(cuda, name):
    """EGCN (its embedding read through the hierarchy columns of a level-2
    graph) and the JK network (cuDNN's LSTM, TF32 off) on the card against
    the CPU, logits and gradients, at dropout 0."""
    from pytextgcn_tpu_torch.models import EGCN, JumpingKnowledgeNetwork
    from pytextgcn_tpu_torch.train.metrics import masked_cross_entropy

    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(6)
    n_vocab, n_docs, e = 300, 400, 8000
    n = n_vocab + n_docs
    g = TextGraph(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_w=rng.random(e).astype(np.float32), y=rng.integers(0, 6, n).astype(np.int32),
        train_mask=np.r_[np.zeros(n_vocab, bool), np.ones(n_docs, bool)],
        val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n_vocab, n_docs=n_docs,
        hierarchy_feats=np.eye(3, dtype=np.float32)[rng.integers(0, 3, n_docs)])
    gen = torch.Generator().manual_seed(0)
    model = (EGCN(g.in_dim, 6, embedding_dim=256, n_hidden_gcn=100, dropout=0.0, generator=gen)
             if name == "egcn" else
             JumpingKnowledgeNetwork(g.in_dim, 6, n_hidden_gcn=100, dropout=0.0, generator=gen))
    out = {}
    for dev in ("cpu", cuda):
        model.to(dev).zero_grad()
        logits = model(NormAdj.from_graph(g, use_pallas=True, device=dev),
                       NodeFeatures.from_graph(g, device=dev))
        masked_cross_entropy(logits, torch.as_tensor(g.y, device=dev).long(),
                             torch.as_tensor(g.train_mask, device=dev)).backward()
        # copies: moving the model moves its gradients in place
        out[str(dev)] = (logits.detach().cpu().clone(),
                         [p.grad.cpu().clone() for p in model.parameters()])
    (cpu, cpu_grads), (gpu, gpu_grads) = out["cpu"], out[str(cuda)]
    scale = float(cpu.abs().max())
    torch.testing.assert_close(gpu, cpu, rtol=0, atol=1e-5 * scale)
    for a, b in zip(gpu_grads, cpu_grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(b.abs().max()) + 1e-9)


def _long_row_plan(rng, n_rows, n_cols, device):
    """Three rows far over SEG_EDGES (cut into many segments), about half
    the rows empty, the rest a few edges each."""
    seg = spmm_cuda.SEG_EDGES
    long_rows = np.repeat([0, 7, n_rows - 1], [20 * seg + 3, 3 * seg, 5 * seg + 2])
    short = rng.integers(0, n_rows // 2, 6000) * 2 + 1  # odd rows only
    rows = np.r_[long_rows, short[short < n_rows]]
    cols = rng.integers(0, n_cols, rows.shape[0])
    w = rng.standard_normal(rows.shape[0]).astype(np.float32)
    return spmm_cuda.build_csr_plan(rows, cols, w, n_rows, n_cols, device)


# the main path's widths (100, 43: two edges a warp), 43 padded by hand
# (44), one 4-column vector a row (1, 4: 32 edges a warp), two edges a warp
# (48, 64), a row padded to 100 (97), one full 128-column block and two
# blocks (128, 130)
WIDTHS = [1, 4, 43, 44, 48, 64, 97, 100, 128, 130]


@pytest.mark.parametrize("h", WIDTHS)
def test_kernel_widths_long_and_empty_rows(cuda, h):
    rng = np.random.default_rng(100 + h)
    csr = _long_row_plan(rng, 900, 900, cuda)
    assert csr.n_partials > 30
    x = torch.randn(900, h, device=cuda)
    before = spmm_cuda.spmm_csr_kernel.launches
    got = spmm_cuda.spmm_csr_kernel(csr, x)
    assert spmm_cuda.spmm_csr_kernel.launches == before + 1
    torch.cuda.synchronize()
    _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))
    empty = torch.ones(900, dtype=torch.bool, device=cuda)
    empty[csr.seg_row[csr.seg_ptr[1:] > csr.seg_ptr[:-1]].long()] = False
    assert empty.sum() > 400 and not got[empty].any()  # exact zeros
    assert torch.equal(got, spmm_cuda.spmm_csr_kernel(csr, x))  # no atomics


@pytest.mark.parametrize("h", [43, 100])
@pytest.mark.parametrize("shape", [(700, 1900), (1900, 700)], ids=["wide", "tall"])
def test_kernel_rectangular_plan(cuda, shape, h):
    n_rows, n_cols = shape
    rng = np.random.default_rng(h)
    csr = _long_row_plan(rng, n_rows, n_cols, cuda)
    x = torch.randn(n_cols, h, device=cuda)
    got = spmm_cuda.spmm_csr_kernel(csr, x)
    assert got.shape == (n_rows, h)
    _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [43, 100])
def test_kernel_x_off_16_bytes(cuda, dtype, h):
    """An x whose data pointer is off 16-byte alignment (a view one element
    into its storage) gives what an aligned copy gives, and stays as it
    was."""
    csr = _long_row_plan(np.random.default_rng(3), 600, 600, cuda)
    base = torch.randn(600 * h + 1, device=cuda).to(dtype)
    x = base[1:].view(600, h)
    assert x.is_contiguous() and x.data_ptr() % 16
    before = x.clone()
    got = spmm_cuda.spmm_csr_kernel(csr, x)
    assert torch.equal(x, before)
    assert torch.equal(got, spmm_cuda.spmm_csr_kernel(csr, x.clone()))
    _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))


@pytest.mark.parametrize("h", [1, 4, 43, 100, 130])
def test_kernel_bf16_widths(cuda, h):
    csr = _long_row_plan(np.random.default_rng(h), 900, 900, cuda)
    x = torch.randn(900, h, device=cuda).bfloat16()
    got = spmm_cuda.spmm_csr_kernel(csr, x)
    assert got.dtype == torch.float32
    _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))
    assert torch.equal(got, spmm_cuda.spmm_csr_kernel(csr, x))


@pytest.mark.parametrize("h", [43, 100])
def test_kernel_pads_narrow_rows_like_a_padded_x(cuda, h):
    """The wrapper's padded copy of x (rows of a multiple of 4 columns)
    gives bit for bit what the kernel gives on an x padded by hand."""
    csr = _long_row_plan(np.random.default_rng(9), 900, 900, cuda)
    x = torch.randn(900, h, device=cuda)
    xp = torch.nn.functional.pad(x, (0, -h % 4 + 4))
    assert torch.equal(spmm_cuda.spmm_csr_kernel(csr, x),
                       spmm_cuda.spmm_csr_kernel(csr, xp)[:, :h])


# ------------------------------------------------- the dual kernel (fused_dual.cu)

from pytextgcn_tpu_torch.ops import fused_dual as fd  # noqa: E402
from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment  # noqa: E402

# main-path widths; N, K and H off the tiles (K = 100: D rows off 16 bytes
# in bf16); two column blocks (H = 130); K < 32 and H = 1; N one row past a
# 128-row slab at the widths where the column tiling changes (48, 49); an
# odd K
DUAL_SHAPES = [(3000, 512, 100), (3000, 512, 43), (1001, 100, 19), (777, 200, 130),
               (129, 7, 1), (129, 96, 48), (129, 96, 49), (1000, 333, 43)]


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


# N on no row slab, K on no K tile: (1000, 300) loads D in 16-byte chunks
# with a ragged last tile, (1000, 333) takes the scalar loads (K * 4 is no
# multiple of 16)
F32_RAGGED_SHAPES = [(1000, 300, 100), (1000, 333, 43), (250, 1030, 8)]


@pytest.mark.parametrize("hot_t", [False, True], ids=["hot_KH", "hot_HK"])
@pytest.mark.parametrize("shape", DUAL_SHAPES[:2] + F32_RAGGED_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
def test_f32_kernel_is_three_tf32_passes(cuda, shape, hot_t):
    """The f32 variant against an f64 oracle and against its own arithmetic
    emulated on the card (``dual_reference_tf32x3``), within 5e-6 of
    |D| @ |x|: three TF32 passes with f32 sums are ~2.5e-7 from the oracle,
    the tensor cores' accumulation (which drops the bits an IEEE sum would
    round) adds ~1.4e-6 at K = 512, and one TF32 pass would be ~1e-4. out
    is written once, without atomics, so two launches give the same bits."""
    d, _, x, xh = _dual_operands(fd.F32, *shape, cuda, seed=11)
    out, hot = fd.fused_dual_kernel(fd.F32, d, None, x, xh, hot_t=hot_t)
    out2, _ = fd.fused_dual_kernel(fd.F32, d, None, x, xh, hot_t=hot_t)
    torch.cuda.synchronize()
    assert torch.equal(out, out2)
    hot = hot.t() if hot_t else hot
    d64 = d.double()
    mag_out, mag_hot = fd.dual_abs(fd.F32, d, None, x, xh)
    _assert_close(out, d64 @ xh.double(), mag_out, rtol=5e-6, atol=0)
    _assert_close(hot, d64.t() @ x.double(), mag_hot, rtol=5e-6, atol=0)
    emu_out, emu_hot = fd.dual_reference_tf32x3(d, x, xh)
    _assert_close(out, emu_out, mag_out, rtol=5e-6, atol=0)
    _assert_close(hot, emu_hot, mag_hot, rtol=5e-6, atol=0)


@pytest.mark.parametrize("hot_t", [False, True], ids=["hot_KH", "hot_HK"])
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16, fd.F32], ids=["split", "bf16", "f32"])
def test_dual_kernel_unaligned_d(cuda, variant, hot_t):
    """D whose pointer is off 16 bytes (vec_ok 0: D copied element by
    element) against the same D aligned."""
    d, d_lo, x, xh = _dual_operands(variant, 300, 256, 100, cuda, seed=5)
    planes = []
    for plane in (d, d_lo) if variant == fd.SPLIT else (d,):
        buf = torch.empty(plane.numel() + 1, dtype=plane.dtype, device=cuda)
        planes.append(buf[1:].view_as(plane))
        planes[-1].copy_(plane)
    assert planes[0].data_ptr() % 16
    out, hot = fd.fused_dual_kernel(variant, planes[0], planes[-1] if variant == fd.SPLIT
                                    else None, x, xh, hot_t=hot_t)
    hot = hot.t() if hot_t else hot
    want_out, want_hot = fd.dual_reference(variant, d, d_lo, x, xh)
    mag_out, mag_hot = fd.dual_abs(variant, d, d_lo, x, xh)
    _assert_close(out, want_out, mag_out)
    _assert_close(hot, want_hot, mag_hot)


@pytest.mark.parametrize("shape", [(3000, 512, 100), (3000, 512, 43), (1000, 333, 43)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16], ids=["split", "bf16"])
def test_dual_out_repeats_bit_for_bit(cuda, variant, shape):
    """out is summed in registers and written once by one block: the same
    bits on every launch (hot is added by reductions in no fixed order)."""
    ops = _dual_operands(variant, *shape, cuda, seed=6)
    first = fd.fused_dual_kernel(variant, *ops)[0]
    assert all(torch.equal(first, fd.fused_dual_kernel(variant, *ops)[0]) for _ in range(3))


@pytest.mark.parametrize("h", [1, 19, 43, 100, 130])
@pytest.mark.parametrize("variant", [fd.SPLIT, fd.BF16], ids=["split", "bf16"])
def test_prologue_planes_equal_plain_bit_for_bit(cuda, variant, h):
    gen = torch.Generator(device=cuda).manual_seed(h)
    a = torch.randn(777, h, generator=gen, device=cuda) * 10.0 ** torch.randint(
        -5, 5, (777, h), generator=gen, device=cuda)
    a = a if variant == fd.SPLIT else a.bfloat16()
    got = fd.fused_dual_kernel.planes(variant, a)
    want = fd.operand_planes(variant, a)
    assert got.shape == want.shape == ((2 if variant == fd.SPLIT else 1), 777, fd.pad_width(h))
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("layout", ["fused_dual_split", "fused_dual"])
def test_one_dual_product_is_one_launch(cuda, layout):
    """The prologue (the split and bf16 planes of x and xh) is part of the
    launch it serves: one dual product counts one launch."""
    d, _, x, xh = _dual_operands(fd.F32, 500, 128, 100, cuda, seed=7)
    operands = fd.split_bf16(d) if layout == "fused_dual_split" else (d.bfloat16(),)
    key = "split" if layout == "fused_dual_split" else "bf16"
    before = dict(fd.fused_dual_kernel.launches)
    getattr(fd, layout)(*operands, x, xh)
    after = dict(fd.fused_dual_kernel.launches)
    assert after.pop(key) == before.pop(key, 0) + 1
    assert after == before


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


# --------------------------------------------- the trainer's operator options


def _restricted_graph(seed=21, n_vocab=600, n_docs=900, e=30_000):
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    train = np.zeros(n, bool)
    train[n_vocab + rng.choice(n_docs, 600, replace=False)] = True
    return TextGraph(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, n, e).astype(np.int32),
        edge_w=(rng.random(e) + 0.1).astype(np.float32),
        y=rng.integers(0, 6, n).astype(np.int32), train_mask=train,
        val_mask=np.zeros(n, bool), test_mask=np.zeros(n, bool),
        n_vocab=n_vocab, n_docs=n_docs)


@pytest.mark.parametrize("h", [43, 100, 4, 600])
def test_kernel_on_the_masked_heads_plans_both_ways(cuda, h):
    """The restricted forward plan [M, N] and its transpose [N, M], whose
    rows are mostly empty: each against the plain version, empty rows exact
    zeros."""
    from pytextgcn_tpu_torch.ops.restricted import build_restricted_adj

    g = _restricted_graph(e=2500)  # sparse: many inputs reach no train row
    r = build_restricted_adj(g, np.flatnonzero(g.train_mask), use_pallas=True, device=cuda)
    fwd, bwd = r.res.fwd, r.res.bwd
    assert (fwd.n_rows, fwd.n_cols, bwd.n_rows, bwd.n_cols) == (600, 1500, 1500, 600)
    for csr in (fwd, bwd):
        x = torch.randn(csr.n_cols, h, device=cuda)
        got = spmm_cuda.spmm_csr_kernel(csr, x)
        torch.cuda.synchronize()
        _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))
        empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
        assert not got[empty].any()
    assert int((bwd.row_ptr[1:] == bwd.row_ptr[:-1]).sum()) > 0


@pytest.mark.parametrize("h", [600, 601, 42, 43])
@pytest.mark.parametrize("hubs", [False, True], ids=["uniform", "hubs"])
def test_kernel_at_the_ensemble_width_and_unaligned_widths(cuda, h, hubs):
    """600: the batched ensemble's width (six members of 100, five column
    blocks of 128); 601, 42, 43: rows that are not a multiple of 4 columns
    (the wrapper pads them)."""
    rng = np.random.default_rng(h + 7)
    plan = _plan(rng, 3000, 40_000, cuda, hubs=hubs)
    x = torch.randn(3000, h, device=cuda)
    for csr in (plan.fwd, plan.bwd):
        got = spmm_cuda.spmm_csr_kernel(csr, x)
        torch.cuda.synchronize()
        _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))


def test_masked_head_training_on_card_matches_cpu(cuda):
    from pytextgcn_tpu_torch.train import Trainer

    g = _restricted_graph(seed=5)
    hists, params = [], []
    for dev in ("cpu", cuda):
        model = GCN(g.in_dim, 6, n_hidden_gcn=100, dropout=0.0,
                    generator=torch.Generator().manual_seed(3))
        t = Trainer(model, lr=0.05, device=dev, masked_head=True)
        before = spmm_cuda.spmm_csr_kernel.shapes.get((600, 1500, 6), 0)
        hists.append([r["loss"] for r in t.fit(g, epochs=5, n_classes=6)])
        params.append([p.detach().cpu() for p in t.model.parameters()])
    # the card's run launched the restricted forward plan once a step
    assert spmm_cuda.spmm_csr_kernel.shapes.get((600, 1500, 6), 0) == before + 5
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(params[1], params[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_batched_ensemble_on_card_matches_cpu(cuda):
    from pytextgcn_tpu_torch.hierarchy import train_per_label

    g = _restricted_graph(seed=9)
    rng = np.random.default_rng(1)
    child = rng.integers(0, 6, g.n_docs)
    parent = child // 2  # 3 members of 2 classes
    runs = []
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(4)
        # dropout 0: the card's generator draws other numbers than the CPU's
        factory = lambda i, o: GCN(i, o, n_hidden_gcn=100, dropout=0.0, generator=gen)
        runs.append(train_per_label(g, child, parent, factory, epochs=5, seed=2, ep=True,
                                    trainer_kwargs={"device": dev}))
    assert spmm_cuda.spmm_csr_kernel.shapes.get((1500, 1500, 300), 0) >= 10
    for tc, tg in zip(*(r["trainers"] for r in runs)):
        for a, b in zip(tg.model.parameters(), tc.model.parameters()):
            torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=2e-4, atol=2e-5)


# ---- the MLP baseline's rectangular plans: S [B, V] and S^T [V, B] at H = 256

def _tfidf_like(rng, b, v, nnz_per_row):
    from scipy import sparse as sp

    rows = np.repeat(np.arange(b), nnz_per_row)
    cols = rng.integers(0, v, rows.shape[0])
    m = sp.csr_matrix((rng.random(rows.shape[0]).astype(np.float32), (rows, cols)),
                      shape=(b, v))
    m.sum_duplicates()
    return m


@pytest.mark.parametrize("h", [256, 128, 43])
@pytest.mark.parametrize("shape", [(2000, 5000), (5000, 900)], ids=["wide", "tall"])
def test_kernel_on_the_mlp_plans_both_ways(cuda, h, shape):
    """The MLP's first layer: S [B, V] forward, S^T [V, B] for dW (many of
    its rows empty: words no train document holds)."""
    from pytextgcn_tpu_torch.models import SparseMatrix

    rng = np.random.default_rng(h)
    m = _tfidf_like(rng, *shape, nnz_per_row=30)
    xs = SparseMatrix.from_scipy(m, use_pallas=True, device=cuda)
    fwd, bwd = xs.plan.fwd, xs.plan.bwd
    assert (fwd.n_rows, fwd.n_cols, bwd.n_rows, bwd.n_cols) == (*shape, *shape[::-1])
    for csr in (fwd, bwd):
        x = torch.randn(csr.n_cols, h, device=cuda)
        got = spmm_cuda.spmm_csr_kernel(csr, x)
        torch.cuda.synchronize()
        _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x), spmm_cuda.spmm_csr_abs(csr, x))
        assert not got[csr.row_ptr[1:] == csr.row_ptr[:-1]].any()


def test_sparse_matmul_autograd_is_the_kernel_both_ways(cuda):
    from pytextgcn_tpu_torch.models import SparseMatrix

    rng = np.random.default_rng(3)
    m = _tfidf_like(rng, 1500, 4000, nnz_per_row=25)
    xs = SparseMatrix.from_scipy(m, use_pallas=True, device=cuda)
    plain = SparseMatrix.from_scipy(m, use_pallas=False, device=cuda)
    w = torch.randn(4000, 256, device=cuda, requires_grad=True)
    w2 = w.detach().clone().requires_grad_(True)
    ct = torch.randn(1500, 256, device=cuda)
    k = spmm_cuda.spmm_csr_kernel
    before = dict(k.shapes)
    (xs.matmul(w) * ct).sum().backward()
    torch.cuda.synchronize()
    assert k.shapes.get((1500, 4000, 256), 0) == before.get((1500, 4000, 256), 0) + 1
    assert k.shapes.get((4000, 1500, 256), 0) == before.get((4000, 1500, 256), 0) + 1
    (plain.matmul(w2) * ct).sum().backward()
    torch.testing.assert_close(w.grad, w2.grad, rtol=1e-5, atol=1e-5)


def test_mlp_training_on_card_matches_cpu(cuda):
    """train_mlp at dropout 0 from the same parameters: the card's kernel
    path against the CPU's plain version, history and parameters."""
    from pytextgcn_tpu_torch.baselines import train_mlp

    rng = np.random.default_rng(5)
    x_tr, x_va = _tfidf_like(rng, 800, 3000, 20), _tfidf_like(rng, 200, 3000, 20)
    y_tr, y_va = rng.integers(0, 5, 800), rng.integers(0, 5, 200)
    runs = [train_mlp(x_tr, y_tr, x_va, y_va, 5, dropout=0.0, epochs=12, early_stopping=False,
                      device=dev) for dev in ("cpu", cuda)]
    (mc, hc), (mg, hg) = runs
    np.testing.assert_allclose([l for l, _ in hg], [l for l, _ in hc], rtol=1e-5)
    for a, b in zip(mg.parameters(), mc.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ["egcn", "jk"])
def test_batched_egcn_and_jk_ensembles_on_card_match_cpu(cuda, name):
    from pytextgcn_tpu_torch.hierarchy import train_per_label
    from pytextgcn_tpu_torch.models import EGCN, JumpingKnowledgeNetwork

    g = _restricted_graph(seed=11)
    rng = np.random.default_rng(2)
    child = rng.integers(0, 6, g.n_docs)
    parent = child // 2
    runs = []
    for dev in ("cpu", cuda):
        gen = torch.Generator().manual_seed(4)
        if name == "egcn":
            factory = lambda i, o: EGCN(i, o, embedding_dim=64, n_hidden_gcn=32, dropout=0.0,
                                        generator=gen)
        else:
            factory = lambda i, o: JumpingKnowledgeNetwork(i, o, n_hidden_gcn=32, dropout=0.0,
                                                           generator=gen)
        runs.append(train_per_label(g, child, parent, factory, epochs=5, seed=2, ep=True,
                                    trainer_kwargs={"device": dev}))
    assert spmm_cuda.spmm_csr_kernel.shapes.get((1500, 1500, 96), 0) >= 10
    for hc, hg in zip(*(r["histories"] for r in runs)):
        np.testing.assert_allclose([x["loss"] for x in hg], [x["loss"] for x in hc],
                                   rtol=2e-4, atol=2e-5)
    for tc, tg in zip(*(r["trainers"] for r in runs)):
        with torch.no_grad():
            lc, lg = tc.predict_logits(g), tg.predict_logits(g).cpu()
        torch.testing.assert_close(lg, lc, rtol=0, atol=1e-4 * float(lc.abs().max()))
        # the embedding, attention and LSTM are left to the logits: many of
        # their gradients are zero or near it, and Adam's normalized steps turn
        # rounding into lr-sized moves there (test_torch_perlabel_ep.py)
        for (n, a), b in zip(tg.model.named_parameters(), tc.model.parameters()):
            if not n.startswith(("att.", "lstm.", "embed.")):
                torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=0,
                                           atol=2e-4 * float(b.detach().abs().max()))


# ---- slice 10: the plan built on the card, device counting, mini-batching

_PLAN_FIELDS = ("row_ptr", "pairs", "seg_ptr", "seg_row", "seg_slot", "split_row", "split_ptr")


@pytest.mark.parametrize("hubs", [False, True], ids=["uniform", "hubs"])
def test_plan_built_on_card_equals_host_plan(cuda, hubs):
    rng = np.random.default_rng(31)
    n, e = 3000, 40_000
    src = rng.integers(0, n, e)
    dst = (np.concatenate([rng.integers(0, 3, e - e // 10), rng.integers(0, n, e // 10)])
           if hubs else rng.integers(0, n, e))
    w = rng.standard_normal(e).astype(np.float32)
    host = spmm_cuda.build_plan_from_arrays(src, dst, w, n, device=cuda)
    card = spmm_cuda.build_plan_from_arrays(*(torch.as_tensor(a, device=cuda)
                                              for a in (src, dst, w)), n, device=cuda)
    for a, b in ((card.fwd, host.fwd), (card.bwd, host.bwd)):
        assert a.device.type == "cuda"
        for f in _PLAN_FIELDS:
            assert torch.equal(getattr(a, f), getattr(b, f)), f
        assert a.n_partials == b.n_partials
    x = torch.randn(n, 43, device=cuda)
    assert torch.equal(spmm_cuda.spmm_csr_kernel(card.fwd, x),
                       spmm_cuda.spmm_csr_kernel(host.fwd, x))


@pytest.mark.parametrize("budget", [1 << 24, 1 << 14], ids=["default-budget", "many-chunks"])
def test_device_counting_on_card_equals_native(cuda, budget):
    from pytextgcn_tpu_torch.build import windows

    rng = np.random.default_rng(3)
    lengths = rng.integers(0, 49, size=3000)
    tokens = np.full((3000, 48), -1, dtype=np.int32)
    for i, length in enumerate(lengths):
        tokens[i, :length] = rng.integers(0, 500, size=length)
    got = windows.word_word_edges_device(tokens, 500, 10, chunk_pair_budget=budget,
                                         device=cuda)
    want = windows.word_word_edges(tokens, 500, 10, backend="native")
    assert got[2] == want[2]
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].tobytes() == want[1].tobytes()


def test_minibatch_training_on_card_matches_cpu(cuda):
    from pytextgcn_tpu_torch.train import Trainer

    g = _restricted_graph(seed=7)
    hists, params = [], []
    for dev in ("cpu", cuda):
        model = GCN(g.in_dim, 6, n_hidden_gcn=100, dropout=0.0,
                    generator=torch.Generator().manual_seed(3))
        # lr 0.005: at 0.05 Adam's normalized steps turn the kernel's other
        # summation order into moves of 2e-5 in 2 of W1's 150,000 entries
        t = Trainer(model, lr=0.005, seed=1, device=dev)
        before = spmm_cuda.spmm_csr_kernel.launches
        hists.append([r["loss"] for r in t.fit_minibatch(g, epochs=2, batch_size=256)])
        params.append([p.detach().cpu() for p in t.model.parameters()])
    # 3 batches an epoch, 4 launches a step on the card
    assert spmm_cuda.spmm_csr_kernel.launches == before + 4 * 3 * 2
    np.testing.assert_allclose(hists[1], hists[0], rtol=1e-5, atol=1e-6)
    for a, b in zip(params[1], params[0]):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


# ---------------------------------------------------------------- the probe and the bench
from pytextgcn_tpu_torch import bench  # noqa: E402


def test_probe_readings_within_the_spec_peaks(cuda):
    from pytextgcn_tpu_torch.ops.probe import _BAG, probe_chip
    from pytextgcn_tpu_torch.train.profiling import H100_PEAK

    pr = probe_chip(device=cuda)
    hbm = H100_PEAK["hbm_gbps"] * 1e9
    readings = [
        ((8 + 512 / _BAG) / (pr.gather_ns * 1e-9), hbm),  # index + sums of the gather-sum
        ((512 + 8) / (pr.gather_copy_ns * 1e-9), hbm),  # rows written + index read
        (pr.stream_bps, hbm), (pr.hbm_bps, hbm),
        (pr.mxu_f32_fps, H100_PEAK["f32_tflops"] * 1e12),
        (pr.mxu_tf32_fps, H100_PEAK["tf32_tflops"] * 1e12),
        (pr.mxu_bf16_fps, H100_PEAK["bf16_tflops"] * 1e12),
    ]
    for got, peak in readings:
        assert 0 < got <= 1.05 * peak, (got, peak)
    assert pr.mxu_f32_fps < pr.mxu_tf32_fps < pr.mxu_bf16_fps
    assert pr.gather_ns < pr.gather_copy_ns
    assert pr.device == torch.cuda.get_device_name(cuda)


@pytest.fixture(scope="module")
def bench_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    # large enough that K = 4096 leaves a residual
    return bench.build_graph(4000, device="cuda")


_VARIANTS = bench.variants(None)


@pytest.mark.parametrize("name,kw", _VARIANTS, ids=[n for n, _ in _VARIANTS])
def test_bench_variant_launches_what_its_plans_imply(cuda, bench_graph, name, kw):
    res = bench.bench_scale(bench_graph, [(name, kw)], cuda, epochs=2)  # raises on a mismatch
    per_step = res["launches_per_step"][name]
    assert per_step == res["expected_launches"][name]
    assert per_step["spmm_csr"] == (0 if name == "segment f32" else 4)
    if f"K{bench.EXPLICIT_K}" in name:
        key = {"hybrid f32": "split", "hybrid f32.highest": "f32", "hybrid bf16": "bf16"}[
            name.split(" K")[0]]
        assert per_step["dual"] == {key: 2 if name.endswith("masked-head") else 4}
    assert np.isfinite(res["loss"][name]) and res["step_s"][name] > 0


# ---- the partitioned operators' plans (parallel/): each rank's forward
# [rows_per, N] and transpose [N, rows_per] plans of the all-gather
# partition, the halo's own [rows_per, rows_per] and remote
# [rows_per, s_max] blocks; the last shards of a graph whose edges all land
# in its first rows hold none

def _shard_graph(n=3000, e=40_000, dst_below=None, seed=0):
    rng = np.random.default_rng(seed)
    return TextGraph(
        edge_src=rng.integers(0, n, e).astype(np.int32),
        edge_dst=rng.integers(0, dst_below or n, e).astype(np.int32),
        edge_w=rng.random(e).astype(np.float32), y=np.zeros(n, np.int32),
        train_mask=np.zeros(n, bool), val_mask=np.zeros(n, bool),
        test_mask=np.zeros(n, bool), n_vocab=n // 2, n_docs=n - n // 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("h", [100, 43])
@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("empty", [False, True], ids=["spread", "empty_shard"])
def test_kernel_on_per_shard_plans(cuda, d, h, dtype, empty):
    from pytextgcn_tpu_torch.parallel import Mesh, build_halo_adj, build_sharded_adj

    g = _shard_graph(dst_below=1000 if empty else None, seed=d)
    for r in range(d):
        mesh = Mesh(None, r, d, cuda)
        adj = build_sharded_adj(g, mesh, use_pallas=True)
        halo = build_halo_adj(g, mesh, use_pallas=True)
        assert (adj.n_edges == 0) == (empty and r * adj.rows_per >= 1000)
        plans = [adj.plan_fwd, adj.plan_bwd, halo.plan_own.fwd, halo.plan_own.bwd]
        plans += [p for rem in halo.plan_rem for p in (rem.fwd, rem.bwd)]
        for csr in plans:
            x32 = torch.randn(csr.n_cols, h, device=cuda)
            x = x32.to(dtype)
            got = spmm_cuda.spmm_csr_kernel(csr, x)
            assert got.shape == (csr.n_rows, h) and got.dtype == torch.float32
            _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x),
                          spmm_cuda.spmm_csr_abs(csr, x))
            if dtype == torch.bfloat16:
                _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x32),
                              spmm_cuda.spmm_csr_abs(csr, x32), rtol=2.0**-8)
            if csr.n_edges == 0:
                assert not got.any()


# ---- the last multi-device paths: a DP rank's MLP plans, an EP rank's width

@pytest.mark.parametrize("d", [2, 4])
def test_kernel_on_a_dp_rank_s_mlp_plans(cuda, d):
    """A data-parallel MLP rank's block of an Amazon-size train matrix
    ([36,001, 41,600], 35 nonzeros a row: the last block padded): its
    ``[b, 41,600]`` plan and the ``[41,600, b]`` transpose at H = 256, the
    padded rows exact zeros."""
    from pytextgcn_tpu_torch.baselines.mlp_pipeline import row_block
    from pytextgcn_tpu_torch.parallel import Mesh

    rng = np.random.default_rng(d)
    n, v = 36_001, 41_600
    m = _tfidf_like(rng, n, v, nnz_per_row=35)
    y = rng.integers(0, 10, n)
    b = -(-n // d)
    for r in (0, d - 1):
        blk = row_block(Mesh(None, r, d, cuda), m, y)
        fwd, bwd = blk.xs.plan.fwd, blk.xs.plan.bwd
        assert (fwd.n_rows, fwd.n_cols, bwd.n_rows, bwd.n_cols) == (b, v, v, b)
        n_real = min(b, n - r * b)
        assert int(blk.mask.sum()) == n_real and not blk.mask[n_real:].any()
        for csr in (fwd, bwd):
            x = torch.randn(csr.n_cols, 256, device=cuda)
            got = spmm_cuda.spmm_csr_kernel(csr, x)
            torch.cuda.synchronize()
            _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x),
                          spmm_cuda.spmm_csr_abs(csr, x))
            if csr is fwd:
                assert not got[n_real:].any()


@pytest.mark.parametrize("members", [3, 2], ids=["2ranks", "4ranks"])
def test_kernel_at_an_ep_rank_s_width(cuda, members):
    """The ensemble's operator at one rank's widths: its block of the six
    members of hidden 100 (3 on 2 ranks, 2 on 4) and of their 6 classes."""
    g = _restricted_graph(seed=members)
    adj = NormAdj.from_graph(g, use_pallas=True, device=cuda)
    for h in (members * 100, members * 6):
        x = torch.randn(g.n_nodes, h, device=cuda)
        for csr in (adj.plan.fwd, adj.plan.bwd):
            got = spmm_cuda.spmm_csr_kernel(csr, x)
            torch.cuda.synchronize()
            _assert_close(got, spmm_cuda.spmm_csr_reference(csr, x),
                          spmm_cuda.spmm_csr_abs(csr, x))


def test_dp_mlp_step_on_card_matches_cpu(cuda):
    """``train_mlp`` over a mesh of one rank at dropout 0 (the
    data-parallel step: the loss sum, the count and the gradients reduced
    and divided): the card's kernel path against the CPU's plain version."""
    from pytextgcn_tpu_torch.baselines import train_mlp
    from pytextgcn_tpu_torch.parallel import Mesh

    rng = np.random.default_rng(7)
    x_tr, x_va = _tfidf_like(rng, 800, 3000, 20), _tfidf_like(rng, 200, 3000, 20)
    y_tr, y_va = rng.integers(0, 5, 800), rng.integers(0, 5, 200)
    runs = [train_mlp(x_tr, y_tr, x_va, y_va, 5, dropout=0.0, epochs=12, early_stopping=False,
                      mesh=Mesh(None, 0, 1, torch.device(dev))) for dev in ("cpu", cuda)]
    (mc, hc), (mg, hg) = runs
    np.testing.assert_allclose([l for l, _ in hg], [l for l, _ in hc], rtol=1e-5)
    for a, b in zip(mg.parameters(), mc.parameters()):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), rtol=1e-4, atol=1e-5)


def _same_bits(a, b):
    """Equal bit for bit, a NaN for a NaN."""
    a, b = a.detach().contiguous(), b.detach().contiguous()
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | (a.isnan() & b.isnan())).all())


def _adam_twins(shapes, dev, amsgrad, seed, unaligned=True, kinds=(Adam, torch.optim.Adam),
                **kw):
    """Two optimizers of ``kinds`` (the port's Adam, torch's foreach Adam),
    each over its own copy of the same parameters: one of each shape and,
    with ``unaligned``, a 4099-element view 4 bytes off 16-byte alignment."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    p0 = [torch.randn(s, device=dev, generator=gen) for s in shapes]
    ours = [torch.nn.Parameter(t.clone()) for t in p0]
    if unaligned:
        buf = torch.randn(4100, device=dev, generator=gen)
        ours.append(torch.nn.Parameter(buf[1:]))
        assert ours[-1].data_ptr() % 16 and ours[-1].is_contiguous()
    theirs = [torch.nn.Parameter(p.detach().clone()) for p in ours]
    return gen, ours, theirs, tuple(
        kind(ps, lr=0.05, amsgrad=amsgrad, **kw, **({"foreach": True} if kind is not Adam else {}))
        for kind, ps in zip(kinds, (ours, theirs)))


def _adam_grads(gen, ours, theirs, nan=False, skip=None):
    """The same gradients on both sides, each over four decades (an
    unaligned parameter's gradient is unaligned too); with ``nan``, every
    97th element of each NaN; the parameter at index ``skip`` gets none
    (``.grad`` None)."""
    for i, (p, q) in enumerate(zip(ours, theirs)):
        g = torch.randn(p.shape, device=p.device, generator=gen)
        g *= 10.0 ** float(torch.empty(()).uniform_(-3, 1))
        if nan:
            g.view(-1)[::97] = float("nan")
        if i == skip:
            p.grad = q.grad = None
        elif p.data_ptr() % 16:
            buf = torch.empty(p.numel() + 1, device=p.device)
            p.grad = buf[1:].view(p.shape).copy_(g)
            q.grad = g
        else:
            p.grad = g.clone()
            q.grad = g


def _assert_adam_same(a, ours, b, theirs):
    for p, q in zip(ours, theirs):
        assert _same_bits(p, q)
        assert a.state[p].keys() == b.state[q].keys()
        for k in a.state[p]:
            assert _same_bits(a.state[p][k], b.state[q][k]), k


@pytest.mark.parametrize("steps", [1, 7, 100])
@pytest.mark.parametrize("amsgrad", [True, False], ids=["amsgrad", "adam"])
def test_adam_kernel_equals_torch_foreach_bit_for_bit(cuda, amsgrad, steps):
    """Sizes 1, 7, 4k + 3, 2-D and 3-D, a parameter off 16-byte alignment
    (the scalar path), a NaN gradient on one step, the 4099-element
    parameter without a gradient every third step (its own step count);
    parameters and state equal to the foreach step's bit for bit after
    ``steps`` steps."""
    shapes = [(1,), (7,), (4099,), (1000, 43), (2000, 100), (100,), (3, 5, 7)]
    gen, ours, theirs, (a, b) = _adam_twins(shapes, cuda, amsgrad, seed=steps)
    for step in range(1, steps + 1):
        _adam_grads(gen, ours, theirs, nan=step == min(steps, 5),
                    skip=2 if step % 3 == 0 else None)
        a.step()
        b.step()
    torch.cuda.synchronize()
    assert any(p.isnan().any() for p in ours)
    assert int(a.state[ours[2]]["step"]) == steps - steps // 3
    _assert_adam_same(a, ours, b, theirs)


@pytest.mark.parametrize("betas", [(0.5, 0.999), (0.2, 0.9)])
@pytest.mark.parametrize("amsgrad", [True, False], ids=["amsgrad", "adam"])
def test_adam_kernel_takes_lerp_s_other_branch(cuda, amsgrad, betas):
    """With ``1 - beta1 >= 0.5`` ATen's lerp_ computes ``g - (g - m) * beta1``;
    so does the kernel, bit for bit over 7 steps."""
    gen, ours, theirs, (a, b) = _adam_twins([(7,), (4099,), (300, 43)], cuda, amsgrad,
                                            seed=11, betas=betas)
    for _ in range(7):
        _adam_grads(gen, ours, theirs)
        a.step()
        b.step()
    torch.cuda.synchronize()
    _assert_adam_same(a, ours, b, theirs)


@pytest.mark.parametrize("amsgrad", [True, False], ids=["amsgrad", "adam"])
@pytest.mark.parametrize("direction", ["to_torch", "from_torch"])
def test_adam_state_dict_round_trips_with_torch_adam(cuda, amsgrad, direction):
    """Three steps on one side, its state dict loaded into the other kind
    over copied parameters, then both step on together bit for bit: the
    kernel's state is torch's, both ways."""
    kinds = (Adam, torch.optim.Adam) if direction == "to_torch" else (torch.optim.Adam, Adam)
    gen, first, second, (a, b) = _adam_twins([(7,), (4099,), (300, 43)], cuda, amsgrad,
                                             seed=13, kinds=kinds)
    for _ in range(3):
        _adam_grads(gen, first, second)
        a.step()
    with torch.no_grad():
        for p, q in zip(first, second):
            q.copy_(p)
    b.load_state_dict(copy.deepcopy(a.state_dict()))
    assert b.state_dict()["param_groups"] == a.state_dict()["param_groups"]
    _assert_adam_same(a, first, b, second)
    for _ in range(5):
        _adam_grads(gen, first, second)
        a.step()
        b.step()
    torch.cuda.synchronize()
    _assert_adam_same(a, first, b, second)


def test_adam_kernel_on_a_156m_element_tensor(cuda):
    """EGCN's embedding, ``[77,923, 2000]``: three AMSGrad steps."""
    gen, ours, theirs, (a, b) = _adam_twins([(77_923, 2000)], cuda, True, seed=3,
                                            unaligned=False)
    for _ in range(3):
        _adam_grads(gen, ours, theirs)
        a.step()
        b.step()
    torch.cuda.synchronize()
    _assert_adam_same(a, ours, b, theirs)


@pytest.mark.parametrize("n_params,per_step", [(6, 1), (50, 2)])
def test_adam_launches_once_a_step(cuda, n_params, per_step):
    """One launch a step over the step's tensors; a second past a table of
    48."""
    params = [torch.nn.Parameter(torch.randn(5 + i, device=cuda)) for i in range(n_params)]
    opt = Adam(params, lr=0.05, amsgrad=True)
    n0 = Adam.launches
    for _ in range(3):
        for p in params:
            p.grad = torch.randn_like(p)
        opt.step()
    assert Adam.launches - n0 == 3 * per_step


@pytest.mark.parametrize("case", ["float64", "bfloat16", "strided", "weight_decay", "capture"])
def test_adam_raises_on_what_the_kernel_does_not_take(cuda, case):
    dtype = {"float64": torch.float64, "bfloat16": torch.bfloat16}.get(case, torch.float32)
    base = torch.randn(8, 6, device=cuda, dtype=dtype)
    p = torch.nn.Parameter(base.t() if case == "strided" else base)
    opt = Adam([p], lr=0.05, amsgrad=True, weight_decay=0.1 if case == "weight_decay" else 0)
    p.grad = torch.randn_like(p)
    if case == "capture":  # its bias corrections are host scalars, as torch's own step's
        with pytest.raises(RuntimeError, match="cannot be captured"):
            with torch.cuda.graph(torch.cuda.CUDAGraph()):
                opt.step()
        return
    error = TypeError if case in ("float64", "bfloat16") else ValueError
    with pytest.raises(error):
        opt.step()
