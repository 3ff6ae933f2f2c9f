"""spmm_launch_us: the mean length, in us, of the program's ``spmm.launch``
spans that start in the traced window (``ops/spmm_cuda.py::
SpmmCsrKernel.__call__``, from its entry to the return of the ctypes call
that launches the CSR kernel): the host's cost of one launch. Nothing is
read where their count is not the kernel's own launch counter over the
traced epochs (another operator, or a program without the span)."""

from benchmark.metrics.host_enqueue_ms import started


def read(run):
    if run.trace is None:
        return None
    found = started(run.trace, "spmm.launch")
    if not found or len(found) != run.traced_launches:
        return None
    return sum(ev["dur"] for ev in found) / len(found)
