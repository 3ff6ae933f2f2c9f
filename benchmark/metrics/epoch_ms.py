"""epoch_ms: the window's length over the epochs completed in it, in ms.
One epoch is a train step and the protocol's evaluation, end to end on the
host clock; ``setup_s + 500 * epoch_ms`` is what one protocol run costs."""


def read(run):
    return 1e3 * sum(run.epoch_s) / len(run.epoch_s) if run.epoch_s else None
