"""The trace arithmetic on a small hand-written chrome trace."""

import json

import pytest

from benchmark import tracing


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid,
            "pid": 1, "args": args}


def mark(ts):
    return ev(tracing.EPOCH_MARK, "user_annotation", ts, 0)


# two epochs between the marks at 100 and 300 us
EVENTS = [
    mark(100), mark(200), mark(300),
    ev("fit", "cpu_op", 90, 220),
    ev("aten::item", "cpu_op", 150, 30),
    ev("Optimizer.step#Adam.step", "user_annotation", 110, 20),
    ev("cudaLaunchKernel", "cuda_runtime", 112, 2, correlation=1),
    ev("cudaLaunchKernel", "cuda_runtime", 140, 2, correlation=2),
    ev("cudaLaunchKernel", "cuda_runtime", 210, 2, correlation=3),
    ev("multi_tensor_apply_kernel", "kernel", 115, 10, tid=7, correlation=1),
    ev("void spmm_segments_kernel<float>(...)", "kernel", 120, 20, tid=7, correlation=2),
    ev("void spmm_segments_kernel<float>(...)", "kernel", 215, 25, tid=7, correlation=3),
    ev("Memcpy DtoH", "gpu_memcpy", 235, 10, tid=7),
    ev("before the window", "kernel", 50, 60, tid=7),  # 100-110 inside
    {"ph": "i", "name": "ignored instant", "ts": 150},
]


@pytest.fixture
def window(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": EVENTS}))
    return tracing.TraceWindow.load(str(path))


def test_window_and_busy_union(window):
    assert (window.t0, window.t1, window.n_epochs) == (100, 300, 2)
    # busy: [100, 110] + [115, 140] + [215, 245]
    assert window.busy_us() == 10 + 25 + 30
    assert window.busy_spans() == [(100, 110), (115, 140), (215, 245)]


def test_device_time_by_name(window):
    by = window.device_us_by_name()
    assert by["void spmm_segments_kernel<float>(...)"] == 45
    assert by["before the window"] == 10
    assert window.kernel_us(["spmm_segments_kernel", "combine_partials_kernel"]) == 45
    assert window.kernel_us(["no_such_kernel"]) is None


def test_optimizer_attribution_by_correlation(window):
    # only correlation 1 was launched inside the Adam range
    assert window.launched_within_us("Optimizer.step#Adam.step") == 10
    assert window.launched_within_us("Optimizer.step#SGD.step") is None


def test_idle_gaps_named_by_the_host(window):
    # gaps [110, 115], [140, 215] and [245, 300]. The first overlaps the Adam
    # range and "fit" by 5 us each: the shorter, innermost, names it. In the
    # second "fit" overlaps 75 us, aten::item 30: the largest overlap wins.
    assert window.idle_gaps() == [("Optimizer.step#Adam.step", 5), ("fit", 75), ("fit", 55)]
    assert tracing.top(window.idle_gaps()) == [["fit", 130e-6], ["Optimizer.step#Adam.step", 5e-6]]


def test_a_gap_no_host_event_covers():
    w = tracing.TraceWindow([mark(0), mark(100)])
    assert w.idle_gaps() == [("host: no traced event", 100)]
    assert w.busy_us() == 0


def test_too_few_marks_is_refused():
    with pytest.raises(ValueError):
        tracing.TraceWindow([mark(0)])


def test_short_names():
    assert tracing.short_name(
        "void (anonymous namespace)::spmm_segments_kernel<float>(int const*, float*)") \
        == "spmm_segments_kernel<float>"
    assert tracing.short_name("void at::native::f<g(int)>(h)") == "f<g(int)>"
    assert tracing.short_name("aten::add") == "aten::add"
    assert len(tracing.short_name("k" * 300)) == 96
