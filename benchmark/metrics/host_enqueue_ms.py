"""host_enqueue_ms: the host's time an epoch, in ms, inside the program's
``fit.train_step`` and ``fit.eval`` spans (``train/trainer.py::Trainer.fit``:
zero_grad, forward, loss, backward and the optimizer step; the evaluation),
clipped to the traced window, over its epochs. The host reads are spans of
their own beside these, so this is the enqueue alone: where it exceeds the
device's time, the device waits for the host.

The helpers below read the program's spans: ``torch.profiler``'s
``user_annotation`` events (kineto's ``gpu_user_annotation`` copies of the
same ranges are left out). A trace without them reads nothing."""

from typing import List, Optional, Sequence, Tuple

from benchmark import tracing

CAT = "user_annotation"
ENQUEUE = ("fit.train_step", "fit.eval")


def spans(trace, names: Sequence[str]) -> List[Tuple[float, float]]:
    """The program's spans named in ``names`` that overlap the window,
    clipped to it (microseconds)."""
    return tracing.clip(((ev["ts"], ev["ts"] + ev["dur"]) for ev in trace.events
                         if ev.get("cat") == CAT and ev.get("name") in names),
                        trace.t0, trace.t1)


def started(trace, name: str) -> List[dict]:
    """The program's spans named ``name`` that start inside the window."""
    return [ev for ev in trace.events if ev.get("cat") == CAT and ev.get("name") == name
            and trace.t0 <= ev["ts"] < trace.t1]


def ms_per_epoch(run, names: Sequence[str]) -> Optional[float]:
    if run.trace is None:
        return None
    found = spans(run.trace, names)
    if not found:
        return None
    return sum(t - s for s, t in found) / 1e3 / run.trace.n_epochs


def read(run):
    return ms_per_epoch(run, ENQUEUE)
