"""CSR SpMM: the hand-written CUDA kernel, its plan, and its plain version.

Port of ``pytextgcn_tpu/ops/spmm_pallas.py``. The TPU kernel
(``_spmm_kernel``) computes ``out[r] = sum_{e: dst_e = r} w_e * x[src_e]``
as one-hot MXU products over padded, destination-sorted edge tiles; its
Hopper replacement (``csrc/spmm_csr.cu``, whose header explains the design)
gathers the rows itself from a destination-sorted CSR plan, so the tile
padding, ``visited`` mask and chunking have no counterpart here.

* :func:`build_csr_plan` — the plan for one direction: CSR arrays plus the
  row segments the kernel's warps work on; built on the host from numpy
  arrays, or on the device from tensors (the same plan bit for bit).
* :func:`spmm_csr_reference` — the plain PyTorch version (gather, weight,
  ``index_add_``) over the same plan arrays.
* :func:`spmm_csr` — the wrapper: the kernel for a CUDA tensor (or raise),
  the plain version for a CPU tensor.
* :class:`SpmmCsrFunction` — autograd: forward on the forward plan,
  backward with the same kernel on the transpose plan.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at first use into
``_build/cuda`` (listed in .gitignore) and loaded with ctypes.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .cuda_lib import CudaLibrary

# Longest run of edges one warp reduces; longer rows are cut into segments
# whose partial sums a second kernel adds (see csrc/spmm_csr.cu).
SEG_EDGES = 256

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class CsrPlan:
    """One direction of ``A`` as a row-sorted CSR ``[n_rows, n_cols]``.

    ``row_ptr`` is the CSR row pointer. ``pairs`` holds each edge's column
    and the float32 bits of its weight in CSR order (edges of a row keep
    their input order), so the kernel reads both in one 8-byte load;
    ``col`` and ``val`` are views of it. ``seg_ptr``/``seg_row``/
    ``seg_slot`` cut each row into segments of at most ``SEG_EDGES`` edges
    (an empty row has one empty segment); ``seg_slot`` is -1 for a row that
    is one segment, else the scratch row its partial sum goes to.
    ``split_row``/``split_ptr`` list the cut rows and their scratch-row
    ranges.
    """

    row_ptr: torch.Tensor  # int32 [n_rows + 1]
    pairs: torch.Tensor  # int32 [E, 2]: (col, val bits)
    seg_ptr: torch.Tensor  # int32 [S + 1]
    seg_row: torch.Tensor  # int32 [S]
    seg_slot: torch.Tensor  # int32 [S]
    split_row: torch.Tensor  # int32 [R]
    split_ptr: torch.Tensor  # int32 [R + 1]
    n_rows: int
    n_cols: int
    n_partials: int

    @property
    def n_edges(self) -> int:
        return int(self.pairs.shape[0])

    @property
    def col(self) -> torch.Tensor:  # int32 [E]
        return self.pairs[:, 0]

    @property
    def val(self) -> torch.Tensor:  # float32 [E]
        return self.pairs[:, 1].view(torch.float32)

    @property
    def device(self) -> torch.device:
        return self.pairs.device


@dataclasses.dataclass
class SpmmPlan:
    """Forward plan (rows = destinations) and transpose plan (rows =
    sources) of the normalized adjacency without its self-loop diagonal."""

    fwd: CsrPlan
    bwd: CsrPlan
    compute_dtype: str = "float32"  # 'float32' | 'bfloat16'


def build_csr_plan(rows, cols, w, n_rows: int, n_cols: int,
                   device: torch.device) -> CsrPlan:
    """CSR + segment plan of ``A[rows[e], cols[e]] += w[e]`` on ``device``.
    Numpy edge arrays are planned on the host and copied; tensors are
    planned on ``device`` by :func:`_build_csr_plan_torch`, which gives the
    same plan bit for bit."""
    if isinstance(rows, torch.Tensor):
        return _build_csr_plan_torch(rows, cols, w, n_rows, n_cols, torch.device(device))
    rows = np.asarray(rows, np.int64)
    cols = np.asarray(cols, np.int64)
    w = np.asarray(w, np.float32)
    e = rows.shape[0]
    _check_edges(e, (rows.min(), rows.max(), cols.min(), cols.max()) if e else None,
                 n_rows, n_cols)
    order = np.argsort(rows, kind="stable")
    counts = np.bincount(rows, minlength=n_rows)
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(counts, out=row_ptr[1:])

    segs_per_row = np.maximum(-(-counts // SEG_EDGES), 1)
    seg_row = np.repeat(np.arange(n_rows, dtype=np.int64), segs_per_row)
    first_seg = np.zeros(n_rows, np.int64)
    np.cumsum(segs_per_row[:-1], out=first_seg[1:])
    k = np.arange(seg_row.shape[0]) - first_seg[seg_row]
    seg_ptr = np.concatenate([row_ptr[seg_row] + k * SEG_EDGES, [e]])

    cut = segs_per_row[seg_row] > 1
    seg_slot = np.where(cut, np.cumsum(cut) - 1, -1)
    split_row = np.flatnonzero(segs_per_row > 1)
    split_ptr = np.zeros(split_row.shape[0] + 1, np.int64)
    np.cumsum(segs_per_row[split_row], out=split_ptr[1:])

    def put(a, dtype=torch.int32):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=device, dtype=dtype)

    pairs = np.stack([cols[order].astype(np.int32), w[order].view(np.int32)], axis=1)
    return CsrPlan(
        row_ptr=put(row_ptr),
        pairs=put(pairs),
        seg_ptr=put(seg_ptr),
        seg_row=put(seg_row),
        seg_slot=put(seg_slot),
        split_row=put(split_row),
        split_ptr=put(split_ptr),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        n_partials=int(split_ptr[-1]),
    )


def _check_edges(e: int, bounds, n_rows: int, n_cols: int) -> None:
    """The kernel's int32 edge offsets, and endpoints ``bounds`` (row min,
    row max, col min, col max; None without edges) inside the matrix."""
    if e >= 2**31:
        raise ValueError(f"{e} edges do not fit the kernel's int32 edge offsets")
    if bounds is not None:
        rmin, rmax, cmin, cmax = (int(b) for b in bounds)
        if rmin < 0 or rmax >= n_rows or cmin < 0 or cmax >= n_cols:
            raise ValueError("edge endpoint out of range")


def _build_csr_plan_torch(rows: torch.Tensor, cols: torch.Tensor, w: torch.Tensor,
                          n_rows: int, n_cols: int, device: torch.device) -> CsrPlan:
    """:func:`build_csr_plan`'s numpy steps in torch on ``device``: a stable
    sort for the stable argsort, ``bincount``/``cumsum`` for ``row_ptr``,
    ``repeat_interleave`` for the segments."""
    rows = rows.to(device=device, dtype=torch.int64)
    cols = cols.to(device=device, dtype=torch.int64)
    w = w.to(device=device, dtype=torch.float32)
    e = rows.shape[0]
    _check_edges(e, torch.stack([rows.min(), rows.max(), cols.min(), cols.max()]).tolist()
                 if e else None, n_rows, n_cols)
    i64 = dict(dtype=torch.int64, device=device)
    order = torch.sort(rows, stable=True).indices
    counts = torch.bincount(rows, minlength=n_rows)
    row_ptr = torch.zeros(n_rows + 1, **i64)
    row_ptr[1:] = torch.cumsum(counts, 0)

    segs_per_row = torch.clamp(-(-counts // SEG_EDGES), min=1)
    n_segs = int(segs_per_row.sum())
    seg_row = torch.repeat_interleave(torch.arange(n_rows, **i64), segs_per_row,
                                      output_size=n_segs)
    first_seg = torch.zeros(n_rows, **i64)
    first_seg[1:] = torch.cumsum(segs_per_row[:-1], 0)
    k = torch.arange(n_segs, **i64) - first_seg[seg_row]
    seg_ptr = torch.cat([row_ptr[seg_row] + k * SEG_EDGES, torch.full((1,), e, **i64)])

    cut = segs_per_row[seg_row] > 1
    seg_slot = torch.where(cut, torch.cumsum(cut, 0) - 1, -1)
    split_row = torch.nonzero(segs_per_row > 1).flatten()
    split_ptr = torch.zeros(split_row.shape[0] + 1, **i64)
    split_ptr[1:] = torch.cumsum(segs_per_row[split_row], 0)

    i32 = lambda t: t.to(torch.int32).contiguous()
    pairs = torch.stack([cols[order].to(torch.int32), w[order].view(torch.int32)], dim=1)
    return CsrPlan(
        row_ptr=i32(row_ptr),
        pairs=pairs.contiguous(),
        seg_ptr=i32(seg_ptr),
        seg_row=i32(seg_row),
        seg_slot=i32(seg_slot),
        split_row=i32(split_row),
        split_ptr=i32(split_ptr),
        n_rows=int(n_rows),
        n_cols=int(n_cols),
        n_partials=int(split_ptr[-1]),
    )


def build_plan_from_arrays(src, dst, w, n_nodes: int, compute_dtype: str = "float32",
                           device: torch.device = torch.device("cpu")) -> SpmmPlan:
    """Forward (``out[dst] += w x[src]``) and transpose plans from numpy
    edge arrays (planned on the host) or tensors (planned on ``device``).
    The transpose plan is built in general, not assumed equal to the
    forward one."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, "
                         f"got {compute_dtype!r}")
    return SpmmPlan(
        fwd=build_csr_plan(dst, src, w, n_nodes, n_nodes, device),
        bwd=build_csr_plan(src, dst, w, n_nodes, n_nodes, device),
        compute_dtype=compute_dtype,
    )


# ------------------------------------------------------------ plain version


# Edges per gather on the CPU: the [chunk, H] products stay in cache (the
# whole [E, H] array made the plain path 7x slower there, for the same sums
# in the same order). The card takes all edges at once.
_CPU_EDGE_CHUNK = 4096


def _csr_sum(csr: CsrPlan, val: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    rows = torch.repeat_interleave(
        torch.arange(csr.n_rows, device=x.device),
        (csr.row_ptr[1:] - csr.row_ptr[:-1]).long(),
    )
    col = csr.col.long()
    out = torch.zeros(csr.n_rows, x.shape[1], dtype=torch.float32, device=x.device)
    step = _CPU_EDGE_CHUNK if x.device.type == "cpu" else max(csr.n_edges, 1)
    for s in range(0, csr.n_edges, step):
        contrib = x.index_select(0, col[s:s + step]).float().mul_(val[s:s + step, None])
        out.index_add_(0, rows[s:s + step], contrib)
    return out


def spmm_csr_reference(csr: CsrPlan, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` in plain PyTorch over the plan's CSR arrays: gather,
    weight, ``index_add_``. Accumulates in float32 whatever x's dtype."""
    return _csr_sum(csr, csr.val, x)


def spmm_csr_abs(csr: CsrPlan, x: torch.Tensor) -> torch.Tensor:
    """``|A| @ |x|`` by the plain version: per output, the sum of its terms'
    magnitudes. Summing the terms in another order moves the result by a
    multiple of eps times this (not of the result, which may cancel to near
    zero), so kernel-vs-plain checks scale their tolerance by it."""
    return _csr_sum(csr, csr.val.abs(), x.abs())


# ------------------------------------------------------------------- kernel


class SpmmCsrKernel:
    """The compiled kernel: builds and loads it once, launches it, and
    counts its launches in ``launches`` (one per SpMM call) and, by
    ``(n_rows, n_cols, H)`` of the launch, in ``shapes`` (full square plans,
    the masked head's rectangular ones, the batched ensemble's widths).
    ``flags`` and ``tag`` make a timing build (``-D`` macros of
    ``csrc/spmm_csr.cu``), never used for a result."""

    def __init__(self, flags=(), tag: str = ""):
        self.launches = 0
        self.shapes: Dict[Tuple[int, int, int], int] = {}
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib = CudaLibrary("spmm_csr.cu", "spmm_csr_launch",
                               [p, p, p, i, p, p, i, i, i, p, p, p, p, i, p],
                               flags=flags, tag=tag)

    def build(self, verbose: bool = False) -> str:
        """Compile ``csrc/spmm_csr.cu`` if needed; see :meth:`CudaLibrary.build`."""
        return self.lib.build(verbose)

    def __call__(self, csr: CsrPlan, x: torch.Tensor) -> torch.Tensor:
        if not x.is_cuda:
            raise ValueError("the CUDA SpMM kernel takes CUDA tensors only")
        if csr.device != x.device:
            raise ValueError(f"plan on {csr.device}, x on {x.device}")
        if x.dtype not in (torch.float32, torch.bfloat16):
            raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
        if x.dim() != 2 or x.shape[0] != csr.n_cols:
            raise ValueError(f"x must be [{csr.n_cols}, H], got {list(x.shape)}")
        if not x.is_contiguous():
            raise ValueError("x must be contiguous")
        h = int(x.shape[1])
        ld = -(-h // 4) * 4  # the kernel reads 4 columns a lane
        if -(-ld // 128) > 65535:  # one grid.y block per 128 columns
            raise ValueError(f"H={h} is too wide for the kernel's grid")
        if ld != h:  # rows of 16 (f32) or 8 (bf16) bytes
            x = torch.nn.functional.pad(x, (0, ld - h))
        elif x.data_ptr() % (4 * x.element_size()):
            x = x.clone()
        out = torch.empty(csr.n_rows, h, dtype=torch.float32, device=x.device)
        partial = torch.empty(csr.n_partials, ld, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            self.lib.launch(
                "spmm_csr",
                csr.seg_ptr.data_ptr(), csr.seg_row.data_ptr(), csr.seg_slot.data_ptr(),
                int(csr.seg_row.shape[0]), csr.pairs.data_ptr(), x.data_ptr(),
                0 if x.dtype == torch.float32 else 1, h, ld,
                out.data_ptr(), partial.data_ptr() if csr.n_partials else None,
                csr.split_row.data_ptr(), csr.split_ptr.data_ptr(),
                int(csr.split_row.shape[0]), stream,
            )
        self.launches += 1
        shape = (csr.n_rows, csr.n_cols, h)
        self.shapes[shape] = self.shapes.get(shape, 0) + 1
        return out


spmm_csr_kernel = SpmmCsrKernel()


def spmm_csr(csr: CsrPlan, x: torch.Tensor) -> torch.Tensor:
    """``A @ x`` for one plan direction, float32 out. A CPU tensor takes the
    plain version; a CUDA tensor takes the kernel, which raises on failure."""
    if x.device.type == "cpu":
        return spmm_csr_reference(csr, x)
    return spmm_csr_kernel(csr, x)


class SpmmCsrFunction(torch.autograd.Function):
    """``(A - diag) @ x`` with the kernel in both directions. The plan gets
    no gradient."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, plan: SpmmPlan) -> torch.Tensor:
        ctx.plan = plan
        ctx.x_dtype = x.dtype
        xc = x.to(_COMPUTE_DTYPES[plan.compute_dtype]).contiguous()
        return spmm_csr(plan.fwd, xc)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        plan = ctx.plan
        gc = g.to(_COMPUTE_DTYPES[plan.compute_dtype]).contiguous()
        return spmm_csr(plan.bwd, gc).to(ctx.x_dtype), None


def spmm_plan(plan: SpmmPlan, x: torch.Tensor) -> torch.Tensor:
    """Differentiable ``(A_hat - diag(self_w)) @ x``; the self-loop diagonal
    is applied by the caller (ops/spmm.py)."""
    return SpmmCsrFunction.apply(x, plan)
