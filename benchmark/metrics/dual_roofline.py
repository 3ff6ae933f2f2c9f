"""dual_roofline: the dual kernel's share of its roofline in the hybrid
aggregation, in %.

The least time of the epoch's dual products (``least_s_per_epoch``, counted
from the configuration and the graph's sizes, never from the program's
plan) over the device time of the dual kernel and its prologue (the kernels
named below) in the traced epochs. Nothing is read unless the program's
``hybrid.dual`` spans that start in the window are one an ``A_hat``
application, six an epoch in a 2-layer ``fit`` evaluating every epoch
(``ops/fused_dual.py::_dual``: one span a product, on the card one launch
of the kernel with its prologue)."""

from typing import Optional

from benchmark import counts
from benchmark.metrics.host_enqueue_ms import started

KERNELS = ("fused_dual_bf16_kernel", "fused_dual_tf32x3_kernel", "fused_dual_prologue_kernel")
SPAN = "hybrid.dual"


def product_least_s(n_nodes: int, k: int, width: int) -> float:
    """The least time of one dual product ``(D @ x_hot, D^T @ x)`` with a
    dense ``[N, K]`` block D read once, at 4 bytes an element (the split
    pair's two bf16 halves, or one float32 block), and x ``[N, H]``, x_hot
    ``[K, H]``, out ``[N, H]`` and hot ``[K, H]`` once each in float32: the
    larger of those bytes over 3.35 TB/s and its operations, ``4 N K H`` (a
    multiply and an add an element of D and column, for each of the two
    products), over the dense bf16 peak, 989 TFLOP/s, the card's highest rate
    for operands of 16 bits or more. A D held sparse, or read twice, is not what this
    counts."""
    byts = 4 * n_nodes * k + 4 * 2 * (n_nodes + k) * width
    ops = 4 * n_nodes * k * width
    return max(byts / counts.H100_PEAK["hbm_bytes_per_s"],
               ops / counts.H100_PEAK["bf16_flops_per_s"])


def least_s_per_epoch(model: dict, trainer: dict, n_nodes: int, n_classes: int) -> float:
    """The least time of the epoch's dual products: one an ``A_hat``
    application (``counts.spmm_widths``), K the configuration's
    ``hybrid_k``."""
    k = int(trainer["hybrid_k"])
    return sum(product_least_s(n_nodes, k, w) for w in counts.spmm_widths(model, n_classes))


def spans_match(run) -> bool:
    """Whether the traced window holds one ``hybrid.dual`` span an ``A_hat``
    application: six an epoch for a 2-layer GCN evaluating every epoch."""
    if run.trace is None or int(run.traffic.get("eval_every", 0)) != 1:
        return False
    per_epoch = len(counts.spmm_widths(run.config["model"], run.n_classes))
    return len(started(run.trace, SPAN)) == per_epoch * run.trace.n_epochs


def read(run) -> Optional[float]:
    if not spans_match(run):
        return None
    us = run.trace.kernel_us(KERNELS)
    if not us:
        return None
    cfg = run.config
    least = least_s_per_epoch(cfg["model"], cfg["trainer"], run.n_nodes, run.n_classes)
    return 100.0 * least * run.trace.n_epochs / (us / 1e6)
