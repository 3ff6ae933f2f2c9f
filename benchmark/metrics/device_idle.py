"""device_idle: the share of an epoch, in %, in which no kernel, copy or set
ran on the card: 1 - the busy union an epoch over the traced epochs, against
the epoch time with the profiler off (the same run's other epochs). The
profiler's own host work stretches the traced epochs of a cell whose host
sets the pace, so the traced window's own idle share (``busy_s`` against
``window_s`` in the result) reads higher there."""

import numpy as np


def read(run):
    if run.trace is None or not run.untraced_epoch_s:
        return None
    busy_s = run.trace.busy_us() / 1e6 / run.trace.n_epochs
    return 100.0 * (1.0 - busy_s / float(np.mean(run.untraced_epoch_s)))
