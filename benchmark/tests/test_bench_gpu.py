"""On the card: the profiler's trace of a small cell's traced epochs holds
what the per-layer readers read, and the control's TF32 rounding is the
tensor cores' own. Skips without a card.

    python3 -m pytest benchmark/tests/test_bench_gpu.py -q
"""

import time

import pytest
import torch

from benchmark import harness
from benchmark.reference import train as rt


@pytest.mark.gpu
def test_a_traced_run_reads_every_per_layer_metric(cuda):
    cell = harness.load_cell("textgcn-amazon.train")
    res = harness.run_cell(cell, 2 ** 31 + 1, 3.0, True, cuda, time.perf_counter(),
                           n_docs=3000, log=lambda *a, **k: None)
    assert res["correct"]
    assert set(res["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < res["metrics"]["spmm_roofline"]["value"] <= 100
    assert 0 < res["device"]["busy_s"] <= res["device"]["window_s"]
    assert res["breakdown"]["device_ops"]


@pytest.mark.gpu
def test_emulated_tf32_is_the_tensor_cores_rounding(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    a = torch.randn(512, 2000, generator=gen, device=cuda)
    b = torch.randn(2000, 100, generator=gen, device=cuda)
    exact = a.double() @ b.double()
    old = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        hw = (a @ b).double()
        torch.backends.cuda.matmul.allow_tf32 = False
        emu = (rt.tf32_round(a) @ rt.tf32_round(b)).double()
        f32 = (a @ b).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old
    err = lambda x: float((x - exact).norm() / exact.norm())
    assert err(f32) * 10 < err(hw)
    assert 0.5 < err(emu) / err(hw) < 2.0
