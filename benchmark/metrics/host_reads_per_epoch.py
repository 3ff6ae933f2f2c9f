"""host_reads_per_epoch: the program's ``fit.host_read`` spans that start in
the traced window, over its epochs: how often an epoch drains the device's
queue to read a number (the loss after the step, then the evaluation's
three)."""

from benchmark.metrics.host_enqueue_ms import started


def read(run):
    if run.trace is None:
        return None
    n = len(started(run.trace, "fit.host_read"))
    return n / run.trace.n_epochs if n else None
