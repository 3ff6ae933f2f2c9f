"""hybrid_plan_s: the newest ``operator.hybrid_plan`` stage of the program,
in s (``ops/hybrid.py::build_hybrid_plan`` once K is known: the hot set,
the symmetry audit, D accumulated on the card and split into its bf16 pair,
``a_hh``, and the residual's CSR plans built on the host and copied to the
card; ``time.perf_counter``), inside ``operator.csr_plan``. A program
without the stage reads nothing."""

from benchmark.metrics.csr_plan_s import newest_stage_s


def read(run):
    return newest_stage_s("operator.hybrid_plan")
