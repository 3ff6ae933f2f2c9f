"""Reading a ``torch.profiler`` chrome trace of the traced epochs.

The union of device spans is a frozen copy of
``pytextgcn_tpu_torch/train/profiling.py::device_busy_us`` (commit 313c710):
kernel, memcpy and memset spans, merged. On top of it: the traced window
(the harness's epoch marks), device time by kernel name, device time of the
kernels a host range launched (matched by correlation id), and the idle
gaps named by what the host was doing.
"""

from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver", "python_function")
EPOCH_MARK = "bench.epoch"

Span = Tuple[float, float]


def merge(spans: Iterable[Span]) -> List[Span]:
    """Disjoint sorted intervals covering ``spans``."""
    out: List[Span] = []
    for s, t in sorted(spans):
        if out and s <= out[-1][1]:
            if t > out[-1][1]:
                out[-1] = (out[-1][0], t)
        else:
            out.append((s, t))
    return out


def clip(spans: Iterable[Span], lo: float, hi: float) -> List[Span]:
    return [(max(s, lo), min(t, hi)) for s, t in spans if t > lo and s < hi]


class TraceWindow:
    """The events of a chrome trace between its first and last epoch mark,
    times in microseconds as the trace gives them."""

    def __init__(self, events: Sequence[dict]):
        self.events = [ev for ev in events if ev.get("ph") == "X"]
        marks = sorted(ev["ts"] for ev in self.events
                       if ev.get("name") == EPOCH_MARK)
        if len(marks) < 2:
            raise ValueError("the trace holds fewer than two epoch marks")
        self.t0, self.t1 = marks[0], marks[-1]
        self.n_epochs = len(marks) - 1
        self.device = [ev for ev in self.events if ev.get("cat") in DEVICE_CATS]
        self.host = [ev for ev in self.events if ev.get("cat") in HOST_CATS
                     and ev.get("name") != EPOCH_MARK]

    @staticmethod
    def load(path: str) -> "TraceWindow":
        with open(path) as f:
            return TraceWindow(json.load(f)["traceEvents"])

    @property
    def window_us(self) -> float:
        return self.t1 - self.t0

    def busy_spans(self) -> List[Span]:
        return clip(merge((ev["ts"], ev["ts"] + ev["dur"]) for ev in self.device),
                    self.t0, self.t1)

    def busy_us(self) -> float:
        return sum(t - s for s, t in self.busy_spans())

    def device_us_by_name(self) -> Dict[str, float]:
        """Device time inside the window by kernel (or copy) name."""
        out: Dict[str, float] = {}
        for ev in self.device:
            for s, t in clip([(ev["ts"], ev["ts"] + ev["dur"])], self.t0, self.t1):
                out[ev["name"]] = out.get(ev["name"], 0.0) + (t - s)
        return out

    def kernel_us(self, names: Sequence[str]) -> Optional[float]:
        """Device time inside the window of the kernels whose name contains
        one of ``names``; None where none ran."""
        hits = [us for name, us in self.device_us_by_name().items()
                if any(n in name for n in names)]
        return sum(hits) if hits else None

    def launched_within_us(self, range_name: str) -> Optional[float]:
        """Device time of the kernels whose launch (the runtime call with the
        same correlation id) lies inside a host range named ``range_name`` on
        the launching thread; None where the trace holds no such range."""
        ranges = [(ev["tid"], ev["ts"], ev["ts"] + ev["dur"]) for ev in self.events
                  if ev.get("name") == range_name and self.t0 <= ev["ts"] < self.t1]
        if not ranges:
            return None
        inside = set()
        for ev in self.events:
            if ev.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            corr = ev.get("args", {}).get("correlation")
            if corr is None:
                continue
            if any(tid == ev["tid"] and s <= ev["ts"] < t for tid, s, t in ranges):
                inside.add(corr)
        return sum(ev["dur"] for ev in self.device
                   if ev.get("args", {}).get("correlation") in inside)

    def idle_gaps(self) -> List[Tuple[str, float]]:
        """The device's idle intervals in the window, each named by the host
        event (innermost on a tie) that overlaps it most."""
        busy = self.busy_spans()
        edges = [self.t0] + [x for span in busy for x in span] + [self.t1]
        gaps = [(s, t) for s, t in zip(edges[0::2], edges[1::2]) if t > s]
        starts = np.array([ev["ts"] for ev in self.host], dtype=np.float64)
        durs = np.array([ev["dur"] for ev in self.host], dtype=np.float64)
        out = []
        for s, t in gaps:
            ov = np.minimum(t, starts + durs) - np.maximum(s, starts)
            if not (ov > 0).any():
                out.append(("host: no traced event", t - s))
                continue
            # the largest overlap, the shortest (innermost) event on a tie
            best = np.lexsort((durs, -ov))[0]
            out.append((self.host[best]["name"], t - s))
        return out


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void``, its argument list and the
    ``at::native`` and anonymous namespaces, cut to ``width`` characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    for noise in ("void ", "at::native::", "(anonymous namespace)::"):
        name = name.replace(noise, "")
    return name[:width]


def top(pairs: Iterable[Tuple[str, float]], n: int = 10) -> List[List]:
    """The ``n`` largest totals of ``(name, microseconds)`` pairs summed by
    short name, as ``[name, seconds]``."""
    tot: Dict[str, float] = {}
    for name, us in pairs:
        name = short_name(name)
        tot[name] = tot.get(name, 0.0) + us
    return [[name, us / 1e6] for name, us in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]
