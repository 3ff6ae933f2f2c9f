"""ensemble_idle_ms: the card's idle time an epoch, in ms, that falls inside
the program's ``ensemble.step`` spans, over the traced epochs: the device
starved while the host enqueues the batched step (idle: no kernel, copy or
set in the window's busy union), as ``idle_enqueue_ms`` reads it for
``Trainer.fit``'s spans."""

from benchmark import tracing
from benchmark.metrics.ensemble_enqueue_ms import STEP
from benchmark.metrics.host_enqueue_ms import spans


def read(run):
    if run.trace is None:
        return None
    step = tracing.merge(spans(run.trace, STEP))
    if not step:
        return None
    busy = tracing.merge(tracing.clip(run.trace.busy_spans(), step[0][0], step[-1][1]))
    covered = sum(t - s for a, b in step for s, t in tracing.clip(busy, a, b))
    return (sum(t - s for s, t in step) - covered) / 1e3 / run.trace.n_epochs
