"""host_read_ms: the host's time an epoch, in ms, inside the program's
``fit.host_read`` spans (``train/trainer.py::Trainer.fit``: each
``loss.item()`` and each ``float`` of the evaluation's numbers), clipped to
the traced window, over its epochs: the host waiting for the device to drain
its queue, and the copy."""

from benchmark.metrics.host_enqueue_ms import ms_per_epoch


def read(run):
    return ms_per_epoch(run, ("fit.host_read",))
