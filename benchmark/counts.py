"""The yardstick's arithmetic: the card's published peaks, the operations
an epoch needs, and the bytes the SpMM applications need.

Everything is counted from the configuration's shapes and the graph's sizes,
never from what the program built (its plans, padding or launches), so a
share computed from it cannot pass 100% unless the time is undercounted.

``H100_PEAK`` is the data sheet's (NVIDIA H100 SXM, dense rates without
sparsity), frozen from ``pytextgcn_tpu_torch/train/profiling.py::H100_PEAK``
at commit 313c710. ``csr_launches_per_epoch`` is a frozen copy of the launch
arithmetic of ``pytextgcn_tpu_torch/bench.py::expected_launches`` (same
commit) for the plain CSR operator.
"""

from __future__ import annotations

from typing import List

from benchmark.weights import model_kind

H100_PEAK = {
    "hbm_bytes_per_s": 3350e9,
    "f32_flops_per_s": 67e12,  # outside the tensor cores
    "tf32_flops_per_s": 495e12,
    "bf16_flops_per_s": 989e12,
}


def peak_flops(precision: dict) -> float:
    """The peak of the configuration's precision: float32 with TF32 off runs
    on the CUDA cores."""
    if precision["dtype"] != "float32":
        raise ValueError(f"no peak for precision {precision['dtype']!r}")
    return H100_PEAK["tf32_flops_per_s" if precision["tf32"] else "f32_flops_per_s"]


def csr_launches_per_epoch(trainer: dict, model: dict, eval_every: int) -> int:
    """CSR-kernel launches an epoch implies on the plain CSR operator: each
    ``A_hat`` application launches once forward and once backward in the
    train step, and once in an evaluation. The hybrid operator and the
    masked head launch by their plans and are not counted here."""
    if trainer["hybrid_k"] is not None or trainer["masked_head"] or not trainer["use_pallas"]:
        raise NotImplementedError("only the plain CSR operator's launches are counted")
    if eval_every != 1:
        raise NotImplementedError("the count assumes an evaluation every epoch")
    return 3 * int(model["n_gcn"])


def spmm_widths(model: dict, n_classes: int) -> List[int]:
    """The widths of the epoch's ``A_hat`` applications: the train step's
    forward ones, their gradients, and the evaluation's forward ones."""
    fwd = model_kind(model).spmm_widths(model, n_classes)
    return fwd + fwd[::-1] + fwd


def spmm_bytes(n_nodes: int, n_edges: int, width: int) -> int:
    """Bytes one application ``A_hat @ x`` at ``width`` needs: its off-diagonal
    edges once (a 4-byte index and a 4-byte weight), the row offsets once,
    x once and the output once, in float32."""
    return 8 * n_edges + 4 * (n_nodes + 1) + 2 * 4 * n_nodes * width


def spmm_least_s_per_epoch(model: dict, n_nodes: int, n_edges: int, n_classes: int,
                           precision: dict) -> float:
    """The least time the epoch's ``A_hat`` applications could take on the
    card: per application the larger of its bytes over the HBM peak and its
    operations (a multiply and an add an edge and column) over the
    precision's peak."""
    return sum(max(spmm_bytes(n_nodes, n_edges, w) / H100_PEAK["hbm_bytes_per_s"],
                   2 * n_edges * w / peak_flops(precision))
               for w in spmm_widths(model, n_classes))


def flops_per_epoch(model: dict, n_nodes: int, n_edges: int, n_classes: int) -> int:
    """The model's operations in one epoch (a train step and a forward
    evaluation), implementation-independent: the model kind's count
    (``benchmark/models/<kind>.py::flops_per_epoch``)."""
    return int(model_kind(model).flops_per_epoch(model, n_nodes, n_edges, n_classes))
