"""epoch_ms.device_paced: ``epoch_ms`` again, in the cells whose device sets
the pace, under the tighter bound that their steadier runs allow (the
shared host's clock moves a host-paced cell's ``epoch_ms`` by about 10% from
run to run, a device-paced cell's by about 1%)."""

from benchmark.metrics import epoch_ms


def read(run):
    return epoch_ms.read(run)
