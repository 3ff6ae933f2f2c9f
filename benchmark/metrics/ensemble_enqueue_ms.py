"""ensemble_enqueue_ms: the host's time an epoch, in ms, inside the program's
``ensemble.step`` spans (``hierarchy/perlabel.py::Ensemble.step``: zero_grad,
the stacked forward with every member's dropout, the members' losses,
backward and the optimizer step), clipped to the traced window, over its
epochs. The epoch's read of the member losses is a span of its own
(``ensemble.host_read``) beside it."""

from benchmark.metrics.host_enqueue_ms import ms_per_epoch

STEP = ("ensemble.step",)


def read(run):
    return ms_per_epoch(run, STEP)
