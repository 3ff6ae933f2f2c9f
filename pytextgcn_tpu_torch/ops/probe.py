"""Run-time probes of the card's ceilings, for the SpMM floor accounting.

Port of ``pytextgcn_tpu/ops/probe.py``. The hybrid plan's
``floor_spmm_ns`` (ops/hybrid.py) is priced from constants; this module
measures the same quantities in the running process, so that the bench
(``pytextgcn_tpu_torch/bench.py``) can hold a step against what this card
does today:

* ``gather_ns``: ns per random f32 row of H = 128 gathered and summed
  (``embedding_bag``, 32 rows a sum), the JAX probe's per-edge quantity
  (the bench's ``x_of_gather_floor``);
* ``gather_copy_ns``: ns per random f32 row of H = 128 copied out
  (``index_select``), the JAX probe's own operation. On an H100 every
  copied row is written to HBM;
* ``stream_bps``: an elementwise-copy chain's bytes a second (read and write
  counted), the streaming ceiling;
* ``hbm_bps``: the D-read rate of ``[nk, 2048] @ [2048, 128]`` in f32 with
  TF32 on, the hybrid dense half's shape class (with TF32 off the product
  is bound by the f32 FMA rate, and its "bytes a second" would be flops over
  intensity);
* ``mxu_f32_fps`` / ``mxu_tf32_fps`` / ``mxu_bf16_fps``: matmul rates at the
  flop-bound width H = 512, f32 with TF32 off, f32 with TF32 on, bf16.

Each quantity is timed at two chain lengths (8 and 40 iterations, each run
ending in a synchronize) and taken as the slope between them, which cancels
any constant per-call cost. When the slope comes out non-positive (noise,
as on a busy CPU) the long chain's mean is used, as in the JAX package, and
the quantity is named in ``ChipProbe.fallbacks``.

The floor formula is the JAX package's (``dense_ns``, ``hybrid_floor_ns``),
but for the residual's price: the JAX form charges an edge ``gather_ns``,
the port ``resid_edge_ns``, the bytes an edge must read from HBM (its
index and weight, ``ops/hybrid.py::RESID_EDGE_BYTES``) at ``stream_bps``.
A library gather is no floor on the card: the CSR kernel runs an edge at
H = 100 five times faster than ``embedding_bag`` gathers a row, its rows
coming from cache. The port's plan fields map onto the formula as
:meth:`ChipProbe.hybrid_floor_ns` says.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Optional, Tuple, Union

import numpy as np
import torch

from ..utils import resolve_device
from .hybrid import RESID_EDGE_BYTES

# chain lengths for slope timing: the long chain carries 5x the device work
# of the short one, so the slope is dominated by real device time
_R_SHORT = 8
_R_LONG = 40
# rows a sum in the gather probe: about the residual's edges a row on the
# 50k-document graph (1.6M residual edges over 78k rows at K = 4096)
_BAG = 32


def _timed(fn, *args, sync, reps: int = 3) -> float:
    fn(*args)
    sync()  # warm up (allocator, library handles)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def slope_time(make_fn, reps: int = 3, r_short: int = _R_SHORT, r_long: int = _R_LONG,
               sync=lambda: None) -> Tuple[float, bool]:
    """Per-iteration seconds of ``make_fn(length)``'s chained body, as the
    slope between a short and a long chain: ``(t_long - t_short) / (r_long
    - r_short)``, each the best of ``reps`` runs ending in ``sync()``. Any
    constant per-call cost cancels. Returns ``(seconds, fell_back)``: a
    non-positive slope falls back to the long chain's mean, and says so."""
    fn_s, args_s = make_fn(r_short)
    fn_l, args_l = make_fn(r_long)
    t_s = _timed(fn_s, *args_s, sync=sync, reps=reps)
    t_l = _timed(fn_l, *args_l, sync=sync, reps=reps)
    dt = (t_l - t_s) / (r_long - r_short)
    if dt > 0:
        return dt, False
    return t_l / r_long, True


@dataclasses.dataclass
class ChipProbe:
    gather_ns: float  # per random f32 H=128 row, gathered and summed
    hbm_bps: float  # D-read bytes/s of [nk, 2048] @ [2048, 128], f32, TF32 on
    mxu_f32_fps: float  # f32 flop/s at H=512, TF32 off
    mxu_bf16_fps: float  # bf16 flop/s at H=512
    probe_s: float  # wall time spent probing
    stream_bps: float = 0.0  # elementwise copy, read + write counted
    mxu_tf32_fps: float = 0.0  # f32 flop/s at H=512, TF32 on
    gather_copy_ns: float = 0.0  # per random f32 H=128 row, copied out
    device: str = ""
    # the quantities whose slope was non-positive (long-chain mean used)
    fallbacks: Tuple[str, ...] = ()

    def dense_ns(self, n_nodes: int, k: int, h: int, itemsize: int,
                 d_reads: int = 2, bf16_passes: int = 0) -> float:
        """Dense-half roofline term of one hybrid SpMM application from the
        probed ceilings (the JAX package's formula). ``bf16_passes > 0``:
        the split path, that many bf16 passes a product at the bf16 rate."""
        dense_bytes = (d_reads * n_nodes * k + k * k) * itemsize
        dense_flops = 2 * (2 * n_nodes * k + k * k) * h
        if bf16_passes:
            mxu = self.mxu_bf16_fps
            dense_flops *= bf16_passes
        else:
            mxu = self.mxu_f32_fps if itemsize == 4 else self.mxu_bf16_fps
        return max(dense_bytes / self.hbm_bps, dense_flops / mxu) * 1e9

    @property
    def resid_edge_ns(self) -> float:
        """The floor's price of a residual edge: ``RESID_EDGE_BYTES`` at the
        probed streaming rate."""
        return RESID_EDGE_BYTES / self.stream_bps * 1e9

    def hybrid_floor_ns(self, plan, h: int) -> float:
        """Probed floor of one application of a :class:`~.hybrid.HybridPlan`:
        the dense term plus the residual at ``resid_edge_ns`` an edge.

        The port's plan maps onto the JAX package's fields so: ``d_lo`` set
        is the split mode, D (the bf16 hi/lo pair, 4 bytes an element) read
        once, 3 bf16 passes a product; bf16 ``compute_dtype`` reads D once
        whatever ``fused`` says, since the port runs bf16 D in the dual
        kernel always (JAX reads it twice unless fused); f32 'highest' reads
        it once when ``fused``, else twice (two ``torch.mm``)."""
        resid = plan.n_resid * self.resid_edge_ns
        if getattr(plan, "d_lo", None) is not None:
            return self.dense_ns(plan.n_nodes, plan.k, h, itemsize=4, d_reads=1,
                                 bf16_passes=3) + resid
        itemsize = 2 if str(plan.compute_dtype) == "bfloat16" else 4
        d_reads = 1 if (plan.fused or itemsize == 2) else 2
        return self.dense_ns(plan.n_nodes, plan.k, h, itemsize, d_reads) + resid


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def probe_chip(reps: int = 3, seed: int = 0, e: int = 2_000_000, nk: int = 50_048,
               device: Optional[Union[str, torch.device]] = None,
               chain: Tuple[int, int] = (_R_SHORT, _R_LONG)) -> ChipProbe:
    """Measure this device's gather, stream and matmul ceilings (about 2 s on
    the card). ``device``: None means the GPU (raises without one).
    ``e`` / ``nk`` / ``chain`` shrink the probe for the CPU tests."""
    device = resolve_device(device)
    sync = (lambda: torch.cuda.synchronize(device)) if device.type == "cuda" else (lambda: None)
    t_start = time.perf_counter()
    rng = np.random.default_rng(seed)
    fallbacks = []

    def slope(name, make_fn):
        dt, fell_back = slope_time(make_fn, reps=reps, r_short=chain[0], r_long=chain[1],
                                   sync=sync)
        if fell_back:
            fallbacks.append(name)
        return dt

    n, h = max(1000, nk - 48), 128
    idx = torch.as_tensor(rng.integers(0, n, e), device=device)
    x0 = torch.as_tensor(rng.standard_normal((n, h)).astype(np.float32), device=device)

    bags = idx[: e - e % _BAG].view(-1, _BAG)

    def make_gather(length):
        def many(x):
            for _ in range(length):
                g = torch.nn.functional.embedding_bag(bags, x, mode="sum")
                x = x + 1e-12 * g[:2].sum(0, keepdim=True)
            return x

        return many, (x0,)

    def make_copy(length):
        def many(x):
            for _ in range(length):
                g = x.index_select(0, idx)
                x = x + 1e-12 * g[:2].sum(0, keepdim=True)
            return x

        return many, (x0,)

    gather_ns = slope("gather", make_gather) / bags.numel() * 1e9
    gather_copy_ns = slope("gather_copy", make_copy) / e * 1e9

    # pure streaming: a scale chain over an array far larger than L2
    big = torch.as_tensor(rng.standard_normal((nk, 1024)).astype(np.float32), device=device)

    def make_stream(length):
        def many(y):
            for _ in range(length):
                y = y * 0.999
            return y

        return many, (big,)

    stream_bps = 2 * big.numel() * 4 / slope("stream", make_stream)

    k = 2_048
    d32 = torch.as_tensor((rng.standard_normal((nk, k)) / 100).astype(np.float32), device=device)
    # D's entries have std 1e-2, so a round trip D^T (D x) scales x by about
    # 1e-4 sqrt(k nk): undo it, so that no value drifts into subnormals
    rescale = 1.0 / (1e-4 * math.sqrt(k * nk))

    def per_matmul(name, d, h_):
        x0d = torch.as_tensor(rng.standard_normal((k, h_)).astype(np.float32),
                              device=device).to(d.dtype)

        def make(length):
            def many(x):
                for _ in range(length):
                    out = d @ x
                    x = (d.t() @ out) * rescale
                return x

            return many, (x0d,)

        return slope(name, make) / 2  # two products an iteration

    # the D-read rate at the hybrid dense half's shape class, TF32 on so
    # that reading D, not the f32 FMA rate, bounds it
    with _tf32(True):
        hbm_bps = nk * k * 4 / per_matmul("d_read", d32, 128)
        mxu_tf32 = 2 * nk * k * 512 / per_matmul("tf32", d32, 512)
    with _tf32(False):
        mxu_f32 = 2 * nk * k * 512 / per_matmul("f32", d32, 512)
    d16 = d32.to(torch.bfloat16)
    del d32
    mxu_bf16 = 2 * nk * k * 512 / per_matmul("bf16", d16, 512)

    return ChipProbe(
        gather_ns=float(gather_ns),
        hbm_bps=float(hbm_bps),
        mxu_f32_fps=float(mxu_f32),
        mxu_bf16_fps=float(mxu_bf16),
        probe_s=float(time.perf_counter() - t_start),
        stream_bps=float(stream_bps),
        mxu_tf32_fps=float(mxu_tf32),
        gather_copy_ns=float(gather_copy_ns),
        device=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        fallbacks=tuple(fallbacks),
    )
