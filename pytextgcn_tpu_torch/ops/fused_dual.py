"""Fused dual product: ``(D @ x_hot, D^T @ x)`` in one read of ``D``.

Port of ``pytextgcn_tpu/ops/fused_dual.py``. The hybrid SpMM
(:mod:`.hybrid`) needs both products of its ``[N, K]`` hot block D against
skinny ``[., H]`` operands every application; the hand-written CUDA kernel
(``csrc/fused_dual.cu``, whose header explains the design) reads each
element of D once for both. Three storage types of D, one kernel:

* :func:`fused_dual_split` — D as a bf16 (hi, lo) pair from
  :func:`split_bf16`; x and xh are split the same way inside the kernel and
  three bf16 products (hi·hi + hi·lo + lo·hi) are summed in f32 (the
  'split2' precision class, ~2^-18 relative);
* :func:`fused_dual` — one f32 D (exact f32 products, the JAX HIGHEST) or
  one bf16 D (x and xh cast to bf16, f32 sums);
* :func:`fused_dual_t` — :func:`fused_dual` with the hot product written as
  ``[H, K]`` by the kernel and transposed once outside.

Each returns f32 ``(out [N, H], hot [K, H])`` and is differentiable in x
and xh: the backward pass is the same kernel with ``(g_out, g_hot)`` in
place of ``(x, x_hot)`` (``g_x = D @ g_hot``, ``g_xh = D^T @ g_out``). D
gets no gradient: it is a constant block of the adjacency.

A CPU tensor takes the plain PyTorch version of the same products; a CUDA
tensor takes the kernel, which raises on failure.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .cuda_lib import CudaLibrary

SPLIT, BF16, F32 = 0, 1, 2
VARIANT_NAMES = {SPLIT: "split", BF16: "bf16", F32: "f32"}


def split_bf16(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 -> (hi, lo) bf16 pair with ``hi + lo`` carrying ~16 significand
    bits. ``hi`` is ``a`` rounded to bf16 (to nearest even) and ``lo`` the
    same rounding of ``a - hi``, so lo is nonzero wherever a is not a bf16
    value (the JAX docstring records a lo half that silently became 0)."""
    a = a.float()
    hi = a.to(torch.bfloat16)
    lo = (a - hi.float()).to(torch.bfloat16)
    return hi, lo


# ------------------------------------------------------------ plain version


def dual_reference(variant: int, d: torch.Tensor, d_lo: Optional[torch.Tensor],
                   x: torch.Tensor, xh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: ``(D @ xh, D^T @ x)`` in f32 from the
    operands the kernel sees (split: the three hi/lo products; bf16: the
    bf16 values in f32; f32: f32)."""
    if variant == SPLIT:
        dhi, dlo = d.float(), d_lo.float()
        xhi, xlo = (t.float() for t in split_bf16(x))
        xhhi, xhlo = (t.float() for t in split_bf16(xh))
        out = dhi @ xhhi + dhi @ xhlo + dlo @ xhhi
        hot = dhi.t() @ xhi + dlo.t() @ xhi + dhi.t() @ xlo
        return out, hot
    df = d.float()
    return df @ xh.float(), df.t() @ x.float()


def dual_abs(variant: int, d: torch.Tensor, d_lo: Optional[torch.Tensor],
             x: torch.Tensor, xh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(|D| @ |xh|, |D|^T @ |x|)``: per output, the sum of its terms'
    magnitudes, which scales the tolerance of kernel-vs-plain checks (the
    two sum in different orders, the kernel's hot side in a different order
    on every run)."""
    da = (d.float() + d_lo.float()).abs() if variant == SPLIT else d.float().abs()
    return da @ xh.float().abs(), da.t() @ x.float().abs()


# ------------------------------------------------------------------- kernel


class FusedDualKernel:
    """The compiled kernel: builds and loads it once, launches it, and
    counts its launches per variant in ``launches`` (keys 'split', 'bf16',
    'f32', 'f32_t', 'bf16_t'; one per dual product)."""

    def __init__(self):
        self.launches = {}
        p, i = ctypes.c_void_p, ctypes.c_int
        self.lib = CudaLibrary("fused_dual.cu", "fused_dual_launch",
                               [i, i, p, p, p, p, i, i, i, i, p, p, p])

    def build(self, verbose: bool = False) -> str:
        """Compile ``csrc/fused_dual.cu`` if needed; see :meth:`CudaLibrary.build`."""
        return self.lib.build(verbose)

    def __call__(self, variant: int, d: torch.Tensor, d_lo: Optional[torch.Tensor],
                 x: torch.Tensor, xh: torch.Tensor,
                 hot_t: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(out [N, H], hot)`` f32, hot ``[K, H]`` or, with ``hot_t``,
        ``[H, K]``. Operand dtypes: split — D pair bf16, x and xh f32;
        bf16 — all bf16; f32 — all f32."""
        d_dtype, x_dtype = {SPLIT: (torch.bfloat16, torch.float32),
                            BF16: (torch.bfloat16, torch.bfloat16),
                            F32: (torch.float32, torch.float32)}[variant]
        planes = (d, d_lo) if variant == SPLIT else (d,)
        for name, t, dt in [("D", p, d_dtype) for p in planes] + [("x", x, x_dtype),
                                                                  ("xh", xh, x_dtype)]:
            if not t.is_cuda:
                raise ValueError("the CUDA dual kernel takes CUDA tensors only")
            if t.device != d.device:
                raise ValueError(f"{name} on {t.device}, D on {d.device}")
            if t.dtype != dt:
                raise TypeError(f"{name} must be {dt} for the "
                                f"{VARIANT_NAMES[variant]} variant, got {t.dtype}")
            if t.dim() != 2 or not t.is_contiguous():
                raise ValueError(f"{name} must be a contiguous matrix")
        n, k = d.shape
        h = x.shape[1]
        if any(p.shape != d.shape for p in planes):
            raise ValueError("the D pair's halves differ in shape")
        if tuple(x.shape) != (n, h) or tuple(xh.shape) != (k, h):
            raise ValueError(f"x must be [{n}, H] and xh [{k}, H], got {list(x.shape)} "
                             f"and {list(xh.shape)}")
        if max(n, k, h) >= 2**31 or -(-h // 128) > 65535:
            raise ValueError(f"shape {n}x{k}, H={h} is too large for the kernel's grid")
        vec_ok = int(k * d.element_size() % 16 == 0
                     and all(p.data_ptr() % 16 == 0 for p in planes))
        out = torch.empty(n, h, dtype=torch.float32, device=d.device)
        hot = torch.zeros((h, k) if hot_t else (k, h), dtype=torch.float32, device=d.device)
        with torch.cuda.device(d.device):
            stream = torch.cuda.current_stream(d.device).cuda_stream
            self.lib.launch(
                "fused_dual", variant, int(hot_t), d.data_ptr(),
                d_lo.data_ptr() if variant == SPLIT else None, x.data_ptr(), xh.data_ptr(),
                n, k, h, vec_ok, out.data_ptr(), hot.data_ptr(), stream,
            )
        key = VARIANT_NAMES[variant] + ("_t" if hot_t else "")
        self.launches[key] = self.launches.get(key, 0) + 1
        return out, hot


fused_dual_kernel = FusedDualKernel()


def _dual(variant: int, d, d_lo, x, xh, hot_t: bool):
    """Kernel for CUDA tensors, plain version for CPU tensors; hot [K, H]."""
    if x.device.type == "cpu":
        return dual_reference(variant, d, d_lo, x, xh)
    out, hot = fused_dual_kernel(variant, d, d_lo, x.contiguous(), xh.contiguous(), hot_t)
    return out, (hot.t() if hot_t else hot)


class FusedDualFunction(torch.autograd.Function):
    """``(D @ xh, D^T @ x)``; backward is the same product of
    ``(g_out, g_hot)``, cast like the forward operands."""

    @staticmethod
    def forward(ctx, x, xh, d, d_lo, variant: int, hot_t: bool):
        ctx.save_for_backward(d, d_lo)
        ctx.variant, ctx.hot_t = variant, hot_t
        ctx.dtypes = (x.dtype, xh.dtype)
        return _dual(variant, d, d_lo, x, xh, hot_t)

    @staticmethod
    def backward(ctx, g_out, g_hot):
        d, d_lo = ctx.saved_tensors
        cast = torch.bfloat16 if ctx.variant == BF16 else torch.float32
        g_x, g_xh = _dual(ctx.variant, d, d_lo, g_out.to(cast), g_hot.to(cast), ctx.hot_t)
        return g_x.to(ctx.dtypes[0]), g_xh.to(ctx.dtypes[1]), None, None, None, None


def fused_dual_split(dhi: torch.Tensor, dlo: torch.Tensor, x: torch.Tensor,
                     xh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(D @ xh, D^T @ x)`` with ``D = dhi + dlo`` (a bf16 pair), reading
    the pair once; x and xh f32, split to hi/lo inside."""
    return FusedDualFunction.apply(x.float(), xh.float(), dhi, dlo, SPLIT, False)


def _variant_of(d: torch.Tensor) -> int:
    if d.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"D must be float32 or bfloat16, got {d.dtype}")
    return F32 if d.dtype == torch.float32 else BF16


def fused_dual(d: torch.Tensor, x: torch.Tensor,
               xh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(D @ xh, D^T @ x)`` reading D once: f32 D in exact f32, or bf16 D
    with x and xh cast to bf16 and f32 sums. Results are f32."""
    variant = _variant_of(d)
    return FusedDualFunction.apply(x.to(d.dtype), xh.to(d.dtype), d, None, variant, False)


def fused_dual_t(d: torch.Tensor, x: torch.Tensor,
                 xh: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_dual` with the kernel's hot product held as ``[H, K]``
    (the layout of the JAX ``_kernel_t``) and transposed once outside."""
    variant = _variant_of(d)
    return FusedDualFunction.apply(x.to(d.dtype), xh.to(d.dtype), d, None, variant, True)
