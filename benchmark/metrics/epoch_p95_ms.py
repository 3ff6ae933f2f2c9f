"""epoch_p95_ms: the 95th percentile, in ms, of the epochs of a traced run's
window that the profiler was off for, each the gap between two of ``fit``'s
per-epoch log calls (a train step and the protocol's evaluation, end to end
on the host clock). It shows the stalls that ``epoch_ms`` averages away: the
allocator, a plan rebuilt, a synchronization added, the host's hiccups."""

import numpy as np


def read(run):
    if not run.untraced_epoch_s:
        return None
    return 1e3 * float(np.percentile(run.untraced_epoch_s, 95))
