"""ensemble_spmm_roofline: the CSR SpMM kernel's share of its roofline in the
per-label ensemble's batched step, in %.

The least time of the epoch's four ``A_hat`` applications, at ``M * H`` and
``M * C_max`` forward and their gradients (``models/perlabel.py::
spmm_least_s_per_epoch``: per application the larger of its bytes over 3.35
TB/s and its operations, 2 an edge and column, over 67 TFLOP/s), over the
device time an epoch of the kernels named below, over the traced epochs. The
members' class counts are the loop's (``timers["member_classes"]``). Nothing
is read where the program's CSR launches over the traced epochs are not four
an epoch (another operator, or an inference, ran)."""

from benchmark.metrics.spmm_roofline import KERNELS
from benchmark.models import perlabel

LAUNCHES_PER_EPOCH = 4


def read(run):
    c_list = run.timers.get("member_classes")
    if run.trace is None or not c_list:
        return None
    if run.traced_launches != LAUNCHES_PER_EPOCH * run.trace.n_epochs:
        return None
    us = run.trace.kernel_us(KERNELS)
    if not us:
        return None
    cfg = run.config
    least = perlabel.spmm_least_s_per_epoch(cfg["model"], run.n_nodes, run.n_edges, c_list,
                                            cfg["precision"])
    return 100.0 * least * run.trace.n_epochs / (us / 1e6)
