"""graph_replays_per_epoch: the program's ``fit.replay`` spans that start in
the traced window, over its epochs: the CUDA-graph replays that enqueue an
epoch (``train/graphs.py``: the train step's, and the evaluation's at
evaluation points). Nothing is read where the trace holds none (an eager
fit, or a program without the span)."""

from benchmark.metrics.host_enqueue_ms import started


def read(run):
    if run.trace is None:
        return None
    n = len(started(run.trace, "fit.replay"))
    return n / run.trace.n_epochs if n else None
