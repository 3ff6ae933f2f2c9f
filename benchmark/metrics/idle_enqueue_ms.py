"""idle_enqueue_ms: the card's idle time an epoch, in ms, that falls inside
the program's ``fit.train_step`` or ``fit.eval`` spans, over the traced
epochs: the device starved while the host enqueues the step or the
evaluation (idle: no kernel, copy or set in the window's busy union)."""

from benchmark import tracing
from benchmark.metrics.host_enqueue_ms import ENQUEUE, spans


def read(run):
    if run.trace is None:
        return None
    enqueue = tracing.merge(spans(run.trace, ENQUEUE))
    if not enqueue:
        return None
    busy = run.trace.busy_spans()
    overlap, i = 0.0, 0
    for s, t in enqueue:
        while i < len(busy) and busy[i][1] <= s:
            i += 1
        j = i
        while j < len(busy) and busy[j][0] < t:
            overlap += min(t, busy[j][1]) - max(s, busy[j][0])
            j += 1
    idle = sum(t - s for s, t in enqueue) - overlap
    return idle / 1e3 / run.trace.n_epochs
