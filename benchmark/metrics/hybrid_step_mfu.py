"""hybrid_step_mfu: ``step_mfu`` in the hybrid cell, in %: the model's
operations an epoch (``counts.flops_per_epoch``: ``6 nnz (H + C) + 8 N H
C``, independent of how ``A_hat`` is applied) over the mean of the epochs
the profiler was off for, over 67 TFLOP/s (float32, TF32 off). Nothing is
read unless the traced window holds the program's ``hybrid.dual`` spans,
one an ``A_hat`` application (``dual_roofline.spans_match``)."""

from benchmark.metrics import step_mfu
from benchmark.metrics.dual_roofline import spans_match


def read(run):
    return step_mfu.read(run) if spans_match(run) else None
