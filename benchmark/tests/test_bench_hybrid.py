"""The ``textgcn-amazon-hybrid.train`` cell on the CPU at a small size, K
cut to 128: a sound run is correct and runs the hybrid through the port's
own path; a run with the dual product in bfloat16, with ``a_hh`` zeroed or
with the split's lo plane zeroed is not; the TF32 control fails the cell's
limits where the program passes; the cell's three metrics on hand-built
traces."""

import dataclasses
import time
from unittest import mock

import numpy as np
import pytest
import torch

import pytextgcn_tpu_torch.ops.hybrid as hybrid
from benchmark import check, counts, harness, tracing, weights
from benchmark.metrics import dual_roofline

CELL = "textgcn-amazon-hybrid.train"
METRICS = ("dual_roofline", "hybrid_step_mfu", "hybrid_plan_s")
HOT_K = 128
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(cell=None, **trainer):
    """The cell at K = 128 (and ``trainer``'s settings), with fits of 20
    epochs, so that the window's first fit (which holds the compared step)
    ends within a short test window."""
    cell = cell or harness.load_cell(CELL)
    cfg = dict(cell.config, trainer=dict(cell.config["trainer"], hybrid_k=HOT_K, **trainer))
    return dataclasses.replace(cell, config=cfg,
                               traffic=dict(cell.traffic, epochs_per_fit=20))


def run(cell=None, seed=2 ** 31 + 5):
    return harness.run_cell(cell or small(), seed, 0.2, False, CPU, time.perf_counter(),
                            n_docs=400, log=lambda *a, **k: None)


def failed(res):
    return {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 7])
def test_a_sound_run_is_correct(seed):
    spec = harness.load_cell(CELL)
    res = run(seed=seed)
    assert res["correct"] and res["attempted"] > 20 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end} == {"epoch_ms", "setup_s"}


def test_the_cell_runs_the_split_hybrid_through_the_trainer():
    """``Trainer.prepare`` builds a ``HybridPlan`` with the split's lo plane
    and the residual on the CSR kernel's plans, from the configuration's
    settings alone."""
    cell = small()
    assert cell.config["trainer"]["hybrid_f32_mode"] == "split2"
    from benchmark.loops import fit as loop

    _, n_classes, g, _ = harness.make_graph(cell, 3, 400)
    out = loop.run(cell, g, n_classes, 3, 0.0, [], CPU)
    plan = out["adj"].plan
    assert isinstance(plan, hybrid.HybridPlan)
    assert plan.k == HOT_K and plan.d_lo is not None and plan.res is not None


def lo_plane_zeroed():
    """D held as its bf16 hi plane alone: one bf16 pass a product."""
    orig = hybrid.split_bf16

    def split_bf16(a):
        hi, lo = orig(a)
        return hi, torch.zeros_like(lo)

    return mock.patch.object(hybrid, "split_bf16", split_bf16)


def a_hh_zeroed():
    """The hot-hot block counted twice."""
    orig = hybrid.dense_blocks

    def dense_blocks(*a, **k):
        d_full, d_lo, a_hh = orig(*a, **k)
        return d_full, d_lo, torch.zeros_like(a_hh)

    return mock.patch.object(hybrid, "dense_blocks", dense_blocks)


@pytest.mark.parametrize("fault", [lo_plane_zeroed, a_hh_zeroed])
def test_a_planted_fault_is_not_correct(fault):
    with fault():
        res = run()
    assert not res["correct"] and failed(res)


def test_the_dual_in_bfloat16_is_not_correct():
    res = run(small(pallas_dtype="bfloat16"))
    assert not res["correct"] and failed(res)


def test_the_control_fails_and_the_program_passes():
    cell = small()
    seed = 3
    inputs, n_classes, g, _ = harness.make_graph(cell, seed, 800)
    loop = harness.load_loop(cell.traffic["loop"])
    out = loop.run(cell, g, n_classes, seed, 0.0, [], CPU)
    prog_graph, compared = harness.program_graph(g, out["adj"]), out["compared"]
    ref_g = harness.reference_graph(cell, inputs, CPU)
    params = weights.initial_params(cell.config["model"], g.n_nodes, n_classes, seed, CPU)
    ref = loop.reference(cell, ref_g, params, compared, seed, CPU)
    ctl = loop.reference(cell, ref_g, params, compared, seed, CPU, precision="tf32")
    ctl_graph = dict(ref_g, norm_w=ref_g["norm_w"].astype(np.float32),
                     self_w=ref_g["self_w"].astype(np.float32))
    control = check.judge(harness.readings(loop, ctl_graph, ctl, ref_g, ref), cell.limits)
    prog = check.judge(harness.readings(loop, prog_graph, compared, ref_g, ref), cell.limits)
    assert all(c["ok"] for c in prog.values())
    assert not (control["grad_gap"]["ok"] and control["step_grad_gap"]["ok"])


# --------------------------------------------------------------- metrics

CONFIG = harness.load_cell(CELL).config
N, E, C = 78_000, 13_000_000, 43


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}


def trace_run(spans_per_epoch=6, dual_us=100.0, untraced=None):
    """Two epochs between marks at 0, 5000 and 10000 us. Each: six
    ``hybrid.dual`` spans 800 us apart, each holding two prologue launches
    of 1 us and a dual kernel of ``dual_us / 6 - 2`` us, and a GEMM of 50
    us."""
    events = [ev(tracing.EPOCH_MARK, t, 1) for t in (0, 5000, 10000)]
    per = dual_us / 6
    for base in (0, 5000):
        for i in range(spans_per_epoch):
            t = base + 10 + 800 * i
            events += [ev("hybrid.dual", t, per + 5)]
        for i in range(6):
            t = base + 10 + 800 * i
            events += [ev("fused_dual_prologue_kernel", t + 1, 1, cat="kernel"),
                       ev("fused_dual_prologue_kernel", t + 2, 1, cat="kernel"),
                       ev("void fused_dual_bf16_kernel<0, 14, true>(...)", t + 3, per - 2,
                          cat="kernel")]
        events += [ev("gemm", base + 4900, 50, cat="kernel")]
    return harness.Run(config=CONFIG, traffic={"eval_every": 1}, n_nodes=N, n_edges=E,
                       n_classes=C, setup_s=1.0, epoch_s=[0.01] * 50, timers={},
                       trace=tracing.TraceWindow(events), traced_launches=0,
                       untraced_epoch_s=untraced or [0.01] * 40)


def least_s():
    """The epoch's six dual products at K = 4096, by hand: D read once at 4
    bytes an element, x, x_hot, out and hot once in float32; bound by bytes."""
    k = 4096
    total = 0.0
    for h in (100, 43, 43, 100, 100, 43):
        byts = 4 * N * k + 4 * (2 * N * h + 2 * k * h)
        assert 4 * N * k * h / 989e12 < byts / 3350e9
        total += byts / 3350e9
    return total


def test_the_metrics_on_a_hand_built_trace():
    run_ = trace_run()
    read = {name: harness.metric_reader(name)(run_) for name in METRICS[:2]}
    assert read["dual_roofline"] == pytest.approx(100 * least_s() / 100e-6)
    flops = 6 * (E + N) * (100 + C) + 8 * N * 100 * C
    assert read["hybrid_step_mfu"] == pytest.approx(100 * flops / 0.01 / 67e12)


def test_the_roofline_reads_100_where_the_dual_time_equals_the_bound():
    bound_us = least_s() * 1e6
    assert harness.metric_reader("dual_roofline")(trace_run(dual_us=bound_us)) == \
        pytest.approx(100.0)
    # the main path's graph (N = 77,923): 2.37 ms an epoch, 0.4007 ms a
    # product at H = 100 and 0.3895 at 43
    assert dual_roofline.least_s_per_epoch(CONFIG["model"], CONFIG["trainer"], 77_923, C) == \
        pytest.approx(2.3706e-3, rel=1e-4)
    assert dual_roofline.least_s_per_epoch(CONFIG["model"], CONFIG["trainer"], N, C) == \
        pytest.approx(least_s())


@pytest.mark.parametrize("name", METRICS[:2])
def test_the_metrics_read_nothing_without_a_trace(name):
    assert harness.metric_reader(name)(dataclasses.replace(trace_run(), trace=None)) is None


@pytest.mark.parametrize("name", METRICS[:2])
def test_the_metrics_read_nothing_without_dual_spans(name):
    events = [e for e in trace_run().trace.events if e["name"] != "hybrid.dual"]
    run_ = dataclasses.replace(trace_run(), trace=tracing.TraceWindow(events))
    assert harness.metric_reader(name)(run_) is None


@pytest.mark.parametrize("name", METRICS[:2])
@pytest.mark.parametrize("spans", [4, 5, 7, 12])
def test_the_metrics_read_nothing_unless_six_dual_spans_an_epoch(name, spans):
    read = harness.metric_reader(name)
    assert read(trace_run(spans)) is None
    assert read(trace_run(6)) is not None


def test_the_roofline_reads_nothing_without_the_dual_kernel():
    events = [e for e in trace_run().trace.events if "fused_dual" not in e["name"]]
    run_ = dataclasses.replace(trace_run(), trace=tracing.TraceWindow(events))
    assert harness.metric_reader("dual_roofline")(run_) is None


def test_the_plan_stage_reads_the_newest_record(monkeypatch):
    from pytextgcn_tpu_torch.train import profiling

    read = harness.metric_reader("hybrid_plan_s")
    recs = [profiling.Stage("operator.hybrid_plan", 1.0, 3.0, "operator.csr_plan"),
            profiling.Stage("operator.csr_plan", 0.5, 3.5),
            profiling.Stage("operator.hybrid_plan", 10.0, 10.25, "operator.csr_plan")]
    monkeypatch.setattr(profiling, "stages", lambda: recs)
    assert read(trace_run()) == pytest.approx(0.25)
    monkeypatch.setattr(profiling, "stages", lambda: recs[1:2])
    assert read(trace_run()) is None


def test_the_count_needs_no_program():
    """The roofline's count is the configuration's and the graph's: K from
    ``hybrid_k``, the widths from ``counts.spmm_widths``."""
    assert counts.spmm_widths(CONFIG["model"], C) == [100, 43, 43, 100, 100, 43]
    half = dict(CONFIG["trainer"], hybrid_k=2048)
    assert dual_roofline.least_s_per_epoch(CONFIG["model"], half, N, C) < least_s()
