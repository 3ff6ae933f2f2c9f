"""Tracing and profiling: the program's spans and stages, and a
``torch.profiler`` helper.

* ``span(name, **args)``: a range on the hot path. While a ``torch.profiler``
  runs it is ``torch.profiler.record_function(name)``, so the range lands in
  the profiler's chrome trace (category ``user_annotation``) on the same clock
  as the device's kernel, copy and set events. Otherwise it is one shared
  null context, after a single read of the profiler's enabled flag: no
  dispatcher or profiler call. Spans are on exactly when a profiler is.
* ``stage(name)``: a coarse span for set-up work (graph build, operator
  build, kernel builds and loads, each ``Trainer.fit`` call). It keeps a
  record of name, start, end and enclosing stage on the ``time.perf_counter``
  clock, since no profiler runs during set-up, and emits the same range as
  ``span`` when one does. ``stages()`` returns the records; the record keeps
  the newest ``MAX_STAGES``.
* ``trace``: a context manager around ``torch.profiler`` (CPU and, when the
  card is present, CUDA activity) that writes a chrome trace;
  ``device_busy_us`` reads the device's busy time from such a trace.

``H100_PEAK`` holds the H100 SXM data sheet's peaks (dense rates, no
sparsity; the port's one table of them), never a TPU's.

Where each span and stage is opened, and which benchmark metric reads it,
is listed in PERF.md.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import threading
import time
from typing import Deque, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor cores,
# dense bf16 and TF32 on the tensor cores
H100_PEAK = {
    "hbm_gbps": 3350.0,
    "f32_tflops": 67.0,
    "tf32_tflops": 495.0,
    "bf16_tflops": 989.0,
}

# Stage records kept: stages open a few times a process (a Trainer.fit call
# is one), never per epoch; a hyperparameter search fitting thousands of
# models keeps the newest.
MAX_STAGES = 1024

_NULL = contextlib.nullcontext()


def span(name: str, **args):
    """A context manager: ``record_function(name)`` while a profiler runs,
    with ``args`` as its argument string (``k=v`` pairs); else a shared null
    context, chosen by one read of torch's own enabled flag
    (``torch.autograd.profiler._is_profiler_enabled``, which torch's fast
    paths read too)."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NULL
    return torch.profiler.record_function(
        name, ",".join(f"{k}={v}" for k, v in args.items()) if args else None)


@dataclasses.dataclass(frozen=True)
class Stage:
    """One stage: ``start`` and ``end`` on ``time.perf_counter``;
    ``parent`` names the stage open around it on the same thread."""

    name: str
    start: float
    end: float
    parent: Optional[str] = None

    @property
    def seconds(self) -> float:
        return self.end - self.start


_STAGES: Deque[Stage] = collections.deque(maxlen=MAX_STAGES)
_OPEN = threading.local()  # .names: the stages open on this thread, innermost last


@contextlib.contextmanager
def stage(name: str):
    """Record the block as stage ``name`` (also if it raises), and open
    ``span(name)`` around it."""
    names = getattr(_OPEN, "names", None)
    if names is None:
        names = _OPEN.names = []
    parent = names[-1] if names else None
    names.append(name)
    start = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        _STAGES.append(Stage(name, start, time.perf_counter(), parent))
        names.pop()


def stages() -> List[Stage]:
    """The stage records, oldest first (closing order)."""
    return list(_STAGES)


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace"):
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write its chrome trace to
    ``<logdir>/<name>.json``. Yields the profiler; its ``trace_path``
    attribute names the file once the block has ended."""
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
