"""device_busy_ms: the time an epoch, in ms, in which a kernel, copy or set
ran on the card (the busy union over the traced epochs): the part of
``epoch_ms`` that does not move with the host's clock."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.busy_us() / 1e3 / run.trace.n_epochs
