"""csr_plan_s: the newest ``operator.csr_plan`` stage of the program, in s
(``ops/adjacency.py::NormAdj.from_graph``: the CSR kernel's forward and
transpose plans built on the host and copied to the card;
``time.perf_counter``), read from ``train/profiling.py::stages`` in the
run's own process. A program without stages reads nothing."""

from typing import Optional


def newest_stage_s(name: str) -> Optional[float]:
    """The length of the newest stage ``name`` the program recorded, or
    None."""
    from pytextgcn_tpu_torch.train import profiling

    stages = getattr(profiling, "stages", None)
    if stages is None:
        return None
    found = [rec for rec in stages() if rec.name == name]
    return found[-1].end - found[-1].start if found else None


def read(run):
    return newest_stage_s("operator.csr_plan")
