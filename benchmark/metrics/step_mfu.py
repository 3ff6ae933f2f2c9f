"""step_mfu: the model's operations an epoch over the epoch time, as a share
of the card's peak at the configuration's precision, in %.

Operations are counted from the configuration's shapes
(``counts.flops_per_epoch``: ``6 nnz (H + C) + 8 N H C``, EGCN ``+ 8 N E_emb
H``), not from what the program launched. The epoch time is the traced run's
window over its epochs, the profiled epochs (and the one after them, which
carries the profiler's stop) left out. The peak: 67 TFLOP/s for float32 with
TF32 off (the H100 data sheet's rate outside the tensor cores)."""

import numpy as np

from benchmark import counts


def read(run):
    if run.trace is None or not run.untraced_epoch_s:
        return None
    flops = counts.flops_per_epoch(run.config["model"], run.n_nodes, run.n_edges,
                                   run.n_classes)
    epoch_s = float(np.mean(run.untraced_epoch_s))
    return 100.0 * flops / epoch_s / counts.peak_flops(run.config["precision"])
