"""The ``perlabel`` loop and the ``perlabel-amazon.ep`` cell on the CPU at a
small size: a sound run is correct; a run with a fault planted in the
batched ensemble is not (the kernel in bfloat16, a zero padding bias, two
members' dropout generators swapped); the cell's four metrics on a
hand-built trace; the reference loads nothing of the program."""

import dataclasses
import subprocess
import sys
import time
from unittest import mock

import pytest
import torch

import pytextgcn_tpu_torch.hierarchy.perlabel as hpl
from benchmark import harness, tracing
from benchmark.models import perlabel as counts

CELL = "perlabel-amazon.ep"
METRICS = ("ensemble_spmm_roofline", "ensemble_step_mfu", "ensemble_enqueue_ms",
           "ensemble_idle_ms")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several test workers share the machine: one intra-op thread each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def small(cell):
    """Fits of 20 epochs, so that the window's first fit (which holds the
    compared step) ends within a short test window."""
    return dataclasses.replace(cell, traffic=dict(cell.traffic, epochs_per_fit=20))


def run(cell=None, seed=2 ** 31 + 5):
    cell = small(cell or harness.load_cell(CELL))
    return harness.run_cell(cell, seed, 0.2, False, torch.device("cpu"), time.perf_counter(),
                            n_docs=400, log=lambda *a, **k: None)


def failed(res):
    return {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}


@pytest.mark.parametrize("seed", [2 ** 31 + 5, 7])
def test_a_sound_run_is_correct(seed):
    spec = harness.load_cell(CELL)
    res = run(seed=seed)
    assert res["correct"] and res["attempted"] > 20 and res["failed"] == 0
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end} == {"epoch_ms", "setup_s"}


def bf16_kernel():
    cell = harness.load_cell(CELL)
    cfg = dict(cell.config, trainer=dict(cell.config["trainer"], pallas_dtype="bfloat16"))
    return dataclasses.replace(cell, config=cfg)


def test_the_kernel_in_bfloat16_is_not_correct():
    res = run(bf16_kernel())
    assert not res["correct"] and failed(res)


def test_a_zero_padding_bias_is_not_correct():
    with mock.patch.object(hpl, "_PAD_BIAS", 0.0):
        res = run()
    assert not res["correct"] and "loss_gap" in failed(res)


def test_swapped_member_generators_are_not_correct():
    orig = hpl.ep_train_step

    def swapped(params, opt, model, adj, feats, y, mask, generators, c_list=None):
        gens = list(generators)
        gens[0], gens[1] = gens[1], gens[0]
        return orig(params, opt, model, adj, feats, y, mask, gens, c_list)

    with mock.patch.object(hpl, "ep_train_step", swapped):
        res = run()
    assert not res["correct"] and "loss_gap" in failed(res)


def test_a_run_broken_in_the_window_alone_is_not_correct():
    """The generators swapped from the window's first fit on: the set-up's
    epochs are sound, the window's compared step is not."""
    from benchmark.loops import perlabel as loop

    orig_window, orig_step = loop.window, hpl.ep_train_step

    def swapped(params, opt, model, adj, feats, y, mask, generators, c_list=None):
        gens = list(generators)
        gens[0], gens[1] = gens[1], gens[0]
        return orig_step(params, opt, model, adj, feats, y, mask, gens, c_list)

    def window(*a, **k):
        with mock.patch.object(hpl, "ep_train_step", swapped):
            return orig_window(*a, **k)

    with mock.patch.object(loop, "window", window):
        res = run()
    assert not res["correct"]
    assert failed(res) and failed(res) <= {"step_loss_gap", "step_grad_gap"}


# --------------------------------------------------------------- metrics

C_LIST = [3, 12, 2, 20, 3, 3]
CONFIG = harness.load_cell(CELL).config


def ev(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}


def trace_run(launches_per_epoch=4, c_list=C_LIST):
    """Two epochs between marks at 0, 100 and 200 us. Each: the step's span
    [10, 60) with the kernel busy [20, 50) (two CSR kernels of 10 us, a GEMM
    of 10 us), the read [60, 70), the device idle elsewhere."""
    events = [ev(tracing.EPOCH_MARK, t, 1) for t in (0, 100, 200)]
    for base in (0, 100):
        events += [ev("ensemble.step", base + 10, 50), ev("ensemble.host_read", base + 60, 10),
                   ev("ensemble.step", base + 10, 50, cat="gpu_user_annotation"),
                   ev("spmm_segments_kernel<float>", base + 20, 10, cat="kernel"),
                   ev("combine_partials_kernel", base + 30, 10, cat="kernel"),
                   ev("gemm", base + 40, 10, cat="kernel")]
    return harness.Run(config=CONFIG, traffic={}, n_nodes=78_000, n_edges=13_000_000,
                       n_classes=43, setup_s=1.0, epoch_s=[0.01] * 50,
                       timers={"member_classes": c_list},
                       trace=tracing.TraceWindow(events),
                       traced_launches=launches_per_epoch * 2, untraced_epoch_s=[0.01] * 40)


def test_the_metrics_on_a_hand_built_trace():
    run_ = trace_run()
    read = {name: harness.metric_reader(name)(run_) for name in METRICS}
    least = counts.spmm_least_s_per_epoch(CONFIG["model"], 78_000, 13_000_000, C_LIST,
                                          CONFIG["precision"])
    assert read["ensemble_spmm_roofline"] == pytest.approx(100 * least / 20e-6)
    flops = 2 * 13_078_000 * (2 * 600 + 2 * 120) + 6 * 78_000 * 100 * sum(C_LIST)
    assert read["ensemble_step_mfu"] == pytest.approx(100 * flops / 0.01 / 67e12)
    assert read["ensemble_enqueue_ms"] == pytest.approx(50 / 1e3)
    assert read["ensemble_idle_ms"] == pytest.approx(20 / 1e3)


def test_the_arithmetic_of_the_widths():
    assert counts.spmm_widths(CONFIG["model"], C_LIST) == [600, 120, 120, 600]
    # at width 600 an application is bound by its operations, at 120 by bytes
    n, e = 77_923, 13_310_312
    ops = lambda w: 2 * e * w / 67e12
    byts = lambda w: (8 * e + 4 * (n + 1) + 8 * n * w) / 3350e9
    assert ops(600) > byts(600) and ops(120) < byts(120)


@pytest.mark.parametrize("name", METRICS)
def test_the_metrics_read_nothing_without_a_trace(name):
    assert harness.metric_reader(name)(dataclasses.replace(trace_run(), trace=None)) is None


@pytest.mark.parametrize("name", ["ensemble_spmm_roofline", "ensemble_enqueue_ms",
                                  "ensemble_idle_ms"])
def test_the_metrics_read_nothing_where_the_trace_lacks_their_spans_and_kernels(name):
    marks = tracing.TraceWindow([ev(tracing.EPOCH_MARK, t, 1) for t in (0, 100, 200)])
    assert harness.metric_reader(name)(dataclasses.replace(trace_run(), trace=marks)) is None


@pytest.mark.parametrize("launches", [3, 5, 6])
def test_the_roofline_reads_nothing_unless_four_launches_an_epoch(launches):
    read = harness.metric_reader("ensemble_spmm_roofline")
    assert read(trace_run(launches)) is None
    assert read(trace_run(4)) is not None


def test_the_metrics_read_nothing_without_the_member_classes():
    run_ = dataclasses.replace(trace_run(), timers={})
    assert harness.metric_reader("ensemble_spmm_roofline")(run_) is None
    assert harness.metric_reader("ensemble_step_mfu")(run_) is None


def test_the_reference_loads_nothing_of_the_program_or_jax():
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.perlabel, "
            "benchmark.models.perlabel; print(sorted(sys.modules))" % harness.ROOT)
    loaded = eval(subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                                 check=True).stdout)
    tops = {m.split(".")[0] for m in loaded}
    assert not tops & {"jax", "jaxlib", "flax", "pytextgcn_tpu", "pytextgcn_tpu_torch"}
    assert not any(m.startswith("benchmark.loops") or m == "benchmark.program" for m in loaded)
