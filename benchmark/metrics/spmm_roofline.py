"""spmm_roofline: the CSR SpMM kernel's share of its roofline, in %.

The least time the epoch's ``A_hat`` applications could take
(``counts.spmm_least_s_per_epoch``: per application the larger of its bytes
over 3.35 TB/s, with the edge list once, an index and a weight an edge, the
row offsets once, x once and the output once in float32, and its operations,
2 an edge and column, over 67 TFLOP/s) over the device time an epoch of the
kernels named below, summed over the traced epochs. Nothing is read where the
program's CSR launches over the traced epochs are not the six an epoch this
count assumes (another operator ran)."""

from benchmark import counts

KERNELS = ("spmm_segments_kernel", "combine_partials_kernel")


def read(run):
    if run.trace is None:
        return None
    cfg = run.config
    expected = counts.csr_launches_per_epoch(cfg["trainer"], cfg["model"],
                                             int(run.traffic["eval_every"])) * run.trace.n_epochs
    if run.traced_launches != expected:
        return None
    us = run.trace.kernel_us(KERNELS)
    if not us:
        return None
    least = counts.spmm_least_s_per_epoch(cfg["model"], run.n_nodes, run.n_edges,
                                          run.n_classes, cfg["precision"])
    return 100.0 * least * run.trace.n_epochs / (us / 1e6)
