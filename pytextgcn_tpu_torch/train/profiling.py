"""Tracing and profiling utilities.

Port of ``pytextgcn_tpu/train/profiling.py``:

* ``StageTimer``: named phase timers (graph build, train, eval) that emit
  JSONL records;
* ``trace``: a context manager around ``torch.profiler`` (CPU and, when the
  card is present, CUDA activity) that writes a chrome trace;
  ``device_busy_us`` reads the device's busy time from such a trace;
* ``spmm_roofline``: bytes moved, edges a second and the fraction of the
  HBM speed of light for one SpMM application, with the JAX package's
  memory model.

The default peaks are the H100 SXM data sheet's (``H100_PEAK``, dense
rates, no sparsity; the port's one table of them), never a TPU's. A
``peak`` dict given to ``spmm_roofline`` may add ``hbm_gbps_measured``, a
probe's streaming rate (``ops/probe.py``).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor cores,
# dense bf16 and TF32 on the tensor cores
H100_PEAK = {
    "hbm_gbps": 3350.0,
    "f32_tflops": 67.0,
    "tf32_tflops": 495.0,
    "bf16_tflops": 989.0,
}


@dataclass
class StageTimer:
    """Accumulates named stage timings; optionally mirrors to a JSONL file."""

    path: Optional[str] = None
    records: List[Dict] = field(default_factory=list)

    @contextlib.contextmanager
    def stage(self, name: str, **meta):
        t0 = time.time()
        try:
            yield
        finally:
            rec = {"stage": name, "seconds": time.time() - t0, **meta, "ts": t0}
            self.records.append(rec)
            if self.path:
                with open(self.path, "a") as f:
                    f.write(json.dumps(rec) + "\n")

    def summary(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for r in self.records:
            out[r["stage"]] = out.get(r["stage"], 0.0) + r["seconds"]
        return out


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its chrome trace to
    ``<logdir>/<name>.json``. Yields the profiler; its ``trace_path``
    attribute names the file once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.trace_path = os.path.join(logdir, f"{name}.json")
    with prof:
        yield prof
    prof.export_chrome_trace(prof.trace_path)


def device_busy_us(trace_path: str) -> float:
    """Microseconds in which the device ran something, from a chrome trace:
    the union of its kernel, memcpy and memset spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events
                   if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def spmm_roofline(
    n_edges: int,
    n_nodes: int,
    feat_dim: int,
    seconds: float,
    peak: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Roofline accounting for one SpMM application.

    Memory model (the op is bandwidth-bound): each edge reads its (src, w)
    pair plus a feat_dim row of X, and each output row is written once.
    Returns achieved GB/s, effective edges/s, and fraction of the HBM
    speed of light (``peak``: default ``H100_PEAK``).
    """
    peak = peak or H100_PEAK
    bytes_edges = n_edges * (4 + 4)  # src id + weight
    bytes_gather = n_edges * feat_dim * 4  # gathered X rows (uncached model)
    bytes_out = n_nodes * feat_dim * 4
    total_bytes = bytes_edges + bytes_gather + bytes_out
    gbps = total_bytes / seconds / 1e9
    out = {
        "edges_per_s": n_edges / seconds,
        "achieved_gbps": gbps,
        "fraction_of_roofline": gbps / peak["hbm_gbps"],
        "total_bytes": float(total_bytes),
    }
    if "hbm_gbps_measured" in peak:
        out["fraction_of_measured_roofline"] = gbps / peak["hbm_gbps_measured"]
    return out
