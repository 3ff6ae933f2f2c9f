"""ensemble_step_mfu: the per-label ensemble's useful operations an epoch
over the epoch time, as a share of the card's peak at the configuration's
precision, in %.

Operations are counted from the shapes (``models/perlabel.py::
flops_per_epoch``: the four aggregations at ``M * H`` and ``M * C_max``, and
each member's ``[N, H] x [H, C_m]`` product three times at its own class
count, without the block-diagonal's zeros), not from what the program
launched. The epoch time is the mean of the window's epochs the profiler was
off for (the traced ones and the one after them left out). The peak: 67
TFLOP/s for float32 with TF32 off."""

import numpy as np

from benchmark import counts
from benchmark.models import perlabel


def read(run):
    c_list = run.timers.get("member_classes")
    if run.trace is None or not run.untraced_epoch_s or not c_list:
        return None
    flops = perlabel.flops_per_epoch(run.config["model"], run.n_nodes, run.n_edges, c_list)
    epoch_s = float(np.mean(run.untraced_epoch_s))
    return 100.0 * flops / epoch_s / counts.peak_flops(run.config["precision"])
