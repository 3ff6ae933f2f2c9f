"""optimizer_ms: device time an epoch, in ms, of the kernels launched inside
torch's ``Optimizer.step#Adam.step`` range (matched to their launches by
correlation id), over the traced epochs."""

RANGE = "Optimizer.step#Adam.step"


def read(run):
    if run.trace is None:
        return None
    us = run.trace.launched_within_us(RANGE)
    if not us:
        return None
    return us / 1e3 / run.trace.n_epochs
