"""The port's spans and stages (``train/profiling.py``), where the program
opens them (``Trainer.fit``, ``fit_minibatch``, ``Text2Graph``,
``NormAdj.from_graph``, the native library's load), and the benchmark's
readers of them (``benchmark/metrics/``) on hand-built traces and stage
records.

The last test is marked ``gpu`` and skips without a card. On the card
(no JAX there, so tests/conftest.py is skipped and the marker registered on
the command line):
``python -m pytest --noconftest -o "markers=gpu: needs a CUDA device"
tests/test_torch_tracing.py -q``.
"""

import collections
import json
import os
import sys
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import harness, tracing  # noqa: E402
from pytextgcn_tpu_torch import Text2Graph  # noqa: E402
from pytextgcn_tpu_torch.build import native_bridge  # noqa: E402
from pytextgcn_tpu_torch.data import synthetic_corpus  # noqa: E402
from pytextgcn_tpu_torch.models import GCN  # noqa: E402
from pytextgcn_tpu_torch.ops import NormAdj  # noqa: E402
from pytextgcn_tpu_torch.train import Trainer, profiling  # noqa: E402

FIT_SPANS = ("fit.epoch", "fit.train_step", "fit.eval", "fit.host_read", "fit.log")


def _events(prof, tmp_path, name="trace.json"):
    """The complete events of a profiler's chrome trace."""
    path = str(tmp_path / name)
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [ev for ev in json.load(f)["traceEvents"] if ev.get("ph") == "X"]


def _spans(events, name):
    return sorted((ev for ev in events if ev.get("cat") == "user_annotation"
                   and ev["name"] == name), key=lambda ev: ev["ts"])


def _inside(ev, outer):
    return outer["ts"] <= ev["ts"] and ev["ts"] + ev["dur"] <= outer["ts"] + outer["dur"]


def _since(t0):
    """The stage records that started at or after ``t0`` (the record keeps
    only the newest, so a count before and after would not do)."""
    return [r for r in profiling.stages() if r.start >= t0]


def _raise(*args, **kwargs):
    raise AssertionError("a profiler call while no profiler runs")


@pytest.fixture(scope="module")
def graph():
    docs, labels = synthetic_corpus(n_docs=120, n_classes=3, seed=5)
    rng = np.random.default_rng(0)
    test_idx = rng.choice(120, 24, replace=False)
    val_idx = np.setdiff1d(rng.choice(120, 20, replace=False), test_idx)
    return Text2Graph(min_df=1, window_size=5).fit_transform(
        docs, labels, test_idx=test_idx, val_idx=val_idx)


def _trainer(g):
    model = GCN(g.in_dim, 3, n_hidden_gcn=8, dropout=0.5,
                generator=torch.Generator().manual_seed(2))
    return Trainer(model, lr=0.05, device="cpu")


# ------------------------------------------------------------ span, stage


def test_span_makes_no_profiler_call_when_no_profiler_runs(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    with profiling.span("t.off", epoch=1) as a:
        with profiling.span("t.off.inner") as b:
            pass
    # one shared null context, whatever the name and arguments
    assert profiling.span("t.x") is profiling.span("t.y", k=2)
    assert a is None and b is None
    with profiling.stage("t.off.stage"):
        pass
    assert profiling.stages()[-1].name == "t.off.stage"


def test_span_emits_a_user_annotation_under_a_cpu_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.on", epoch=3):
            with profiling.span("t.on.inner"):
                torch.ones(4).sum()
    events = _events(prof, tmp_path)
    outer, inner = _spans(events, "t.on"), _spans(events, "t.on.inner")
    assert len(outer) == 1 and len(inner) == 1 and _inside(inner[0], outer[0])


def test_span_closes_when_its_block_raises(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(KeyError):
            with profiling.span("t.raises"):
                raise KeyError("stop")
        with profiling.span("t.after"):
            pass
    events = _events(prof, tmp_path)
    raised, after = _spans(events, "t.raises"), _spans(events, "t.after")
    assert len(raised) == 1 and len(after) == 1
    assert raised[0]["ts"] + raised[0]["dur"] <= after[0]["ts"]


def test_stage_records_name_times_and_parent_nested_and_across_an_exception():
    with pytest.raises(RuntimeError):
        with profiling.stage("t.outer"):
            with profiling.stage("t.ok"):
                pass
            with profiling.stage("t.fails"):
                raise RuntimeError("stop")
    with profiling.stage("t.next"):
        pass
    recs = profiling.stages()[-4:]
    assert [(r.name, r.parent) for r in recs] == [
        ("t.ok", "t.outer"), ("t.fails", "t.outer"), ("t.outer", None), ("t.next", None)]
    ok, fails, outer, nxt = recs
    assert outer.start <= ok.start <= ok.end <= fails.start <= fails.end <= outer.end
    assert outer.end <= nxt.start
    assert abs(nxt.end - time.perf_counter()) < 60  # the perf_counter clock


def test_stage_emits_its_range_under_a_profiler(tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.stage("t.staged"):
            torch.ones(3).sum()
    assert len(_spans(_events(prof, tmp_path), "t.staged")) == 1
    assert profiling.stages()[-1].name == "t.staged"


def test_stage_record_keeps_the_newest(monkeypatch):
    monkeypatch.setattr(profiling, "_STAGES", collections.deque(maxlen=profiling.MAX_STAGES))
    for i in range(profiling.MAX_STAGES + 7):
        with profiling.stage(f"t.{i}"):
            pass
    recs = profiling.stages()
    assert len(recs) == profiling.MAX_STAGES
    assert recs[0].name == "t.7" and recs[-1].name == f"t.{profiling.MAX_STAGES + 6}"


# -------------------------------------------------------- where they open


@pytest.mark.parametrize("eval_every", [1, 2])
def test_fit_spans_each_epoch(graph, tmp_path, eval_every):
    trainer = _trainer(graph)
    logged = []
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit(graph, epochs=4, n_classes=3, eval_every=eval_every, verbose=1,
                    log_fn=logged.append)
    events = _events(prof, tmp_path)
    epochs = _spans(events, "fit.epoch")
    assert len(epochs) == 4
    for k, ep in enumerate(epochs, 1):
        evaluated = k % eval_every == 0
        counts = {name: sum(_inside(ev, ep) for ev in _spans(events, name))
                  for name in FIT_SPANS[1:]}
        assert counts == {"fit.train_step": 1, "fit.eval": int(evaluated),
                          "fit.host_read": 4 * evaluated, "fit.log": int(evaluated)}
    # the reads are siblings of the step and the evaluation, not inside them
    for outer in _spans(events, "fit.train_step") + _spans(events, "fit.eval"):
        assert not any(_inside(ev, outer) for ev in _spans(events, "fit.host_read"))
    # one more fit.log, outside the epochs: the closing line
    assert len(_spans(events, "fit.log")) == 4 // eval_every + 1
    assert len(logged) == 4 // eval_every + 1
    assert [r.name for r in _since(t0) if r.name == "trainer.fit"] == ["trainer.fit"]


def test_fit_closes_its_spans_and_stage_when_log_fn_raises(graph, tmp_path):
    class Stop(Exception):
        pass

    def log_fn(msg):
        if msg.startswith("[2]"):
            raise Stop

    trainer = _trainer(graph)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(Stop):
            trainer.fit(graph, epochs=5, n_classes=3, verbose=1, log_fn=log_fn)
        with profiling.span("t.after_stop"):
            pass
    events = _events(prof, tmp_path)
    assert len(_spans(events, "fit.epoch")) == 2 and len(_spans(events, "fit.log")) == 2
    last = profiling.stages()[-1]
    assert last.name == "trainer.fit" and last.parent is None
    with profiling.stage("t.after_fit"):
        pass
    assert profiling.stages()[-1].parent is None


def test_fit_minibatch_spans_each_epoch(graph, tmp_path):
    trainer = _trainer(graph)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.fit_minibatch(graph, epochs=2, batch_size=32, verbose=1, log_fn=lambda m: None)
    events = _events(prof, tmp_path)
    epochs = _spans(events, "fit.epoch")
    assert len(epochs) == 2
    n_batches = len(trainer.minibatch_seconds) // 2
    for ep in epochs:
        counts = {name: sum(_inside(ev, ep) for ev in _spans(events, name))
                  for name in FIT_SPANS[1:]}
        assert counts == {"fit.train_step": n_batches, "fit.eval": 0, "fit.host_read": 1,
                          "fit.log": 1}


def test_graph_and_operator_builds_record_their_stages():
    docs, labels = synthetic_corpus(n_docs=80, n_classes=3, seed=9)
    t0 = time.perf_counter()
    g = Text2Graph(min_df=1, window_size=5).fit_transform(docs, labels)
    NormAdj.from_graph(g, use_pallas=True, device="cpu")
    names = [r.name for r in _since(t0)]
    assert [n for n in names if n.startswith(("graph.", "operator."))] == [
        "graph.vocabulary", "graph.encode", "graph.tfidf", "graph.word_edges",
        "graph.assemble", "operator.normalize", "operator.csr_plan", "operator.upload"]


def test_native_library_records_a_build_only_when_it_builds(monkeypatch):
    built = []
    native_bridge.load_native()  # built, if this checkout has not built it yet
    monkeypatch.setattr(native_bridge, "_LIB", None)
    t0 = time.perf_counter()
    native_bridge.load_native()
    assert [r.name for r in _since(t0)] == ["kernels.load"]

    monkeypatch.setattr(native_bridge, "_LIB", None)
    monkeypatch.setattr(native_bridge, "_stale", lambda out: True)
    monkeypatch.setattr(native_bridge, "_build", lambda: built.append(1))
    t0 = time.perf_counter()
    native_bridge.load_native()
    assert built == [1]
    assert [r.name for r in _since(t0)] == ["kernels.build", "kernels.load"]


# ----------------------------------------------------------------- readers


def _ev(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1,
            "args": args}


def _window_events():
    """Two epochs between the marks at 0, 100 and 200 us. Each: a step's
    enqueue [10, 40) with four launches of 2 us, a read [40, 50), the
    evaluation's enqueue [50, 60) with two launches of 3 us, three reads of 2
    us; the device busy [20, 45) and [52, 58). Every span is copied as
    kineto copies it onto the device's timeline, which no reader counts."""
    events = [_ev(tracing.EPOCH_MARK, t, 1) for t in (0, 100, 200)]
    for base in (0, 100):
        spans = [("fit.epoch", 5, 90), ("fit.train_step", 10, 30), ("fit.host_read", 40, 10),
                 ("fit.eval", 50, 10), ("fit.host_read", 60, 2), ("fit.host_read", 62, 2),
                 ("fit.host_read", 64, 2), ("fit.log", 66, 30)]
        spans += [("spmm.launch", 11 + 5 * i, 2) for i in range(4)]
        spans += [("spmm.launch", 51 + 4 * i, 3) for i in range(2)]
        for name, ts, dur in spans:
            events.append(_ev(name, base + ts, dur))
            events.append(_ev(name, base + ts, dur, cat="gpu_user_annotation"))
        events.append(_ev("spmm_segments_kernel", base + 20, 25, cat="kernel"))
        events.append(_ev("gemm", base + 52, 6, cat="kernel"))
    # outside the window: a read before it, a step cut by its end
    events.append(_ev("fit.host_read", -20, 5))
    events.append(_ev("fit.train_step", 190, 30))
    return events


def _run(events=None, launches=12):
    trace = tracing.TraceWindow(events if events is not None else _window_events())
    return harness.Run(config={}, traffic={}, n_nodes=1, n_edges=1, n_classes=1, setup_s=1.0,
                       epoch_s=[1e-4, 1e-4], timers={}, trace=trace,
                       traced_launches=launches)


def _marks_only():
    return [_ev(tracing.EPOCH_MARK, t, 1) for t in (0, 100, 200)]


# the step cut by the window's end adds 10 us to the enqueue in the second
# epoch: (30 + 10) * 2 + 10 over 2 epochs; idle under it: [10, 20) and
# [45, 52) is not enqueue, [50, 52) and [58, 60) are, and [190, 200)
WINDOW_READINGS = [
    ("host_enqueue_ms", (2 * (30 + 10) + 10) / 1e3 / 2),
    ("host_read_ms", 2 * (10 + 3 * 2) / 1e3 / 2),
    ("host_reads_per_epoch", 4.0),
    ("spmm_launch_us", (8 * 2 + 4 * 3) / 12),
    ("idle_enqueue_ms", (2 * (10 + 2 + 2) + 10) / 1e3 / 2),
]


@pytest.mark.parametrize("name,want", WINDOW_READINGS, ids=[n for n, _ in WINDOW_READINGS])
def test_window_readers_on_a_hand_built_trace(name, want):
    read = harness.metric_reader(name)
    assert read(_run()) == pytest.approx(want)
    # nothing to read: no trace, or a trace without the program's spans
    assert read(harness.Run(config={}, traffic={}, n_nodes=1, n_edges=1, n_classes=1,
                            setup_s=1.0, epoch_s=[1.0], timers={})) is None
    assert read(_run(_marks_only(), launches=0)) is None


def test_spmm_launch_us_reads_nothing_where_the_launch_count_differs():
    read = harness.metric_reader("spmm_launch_us")
    assert read(_run(launches=12)) == pytest.approx(28 / 12)
    assert read(_run(launches=11)) is None and read(_run(launches=13)) is None


@pytest.mark.parametrize("name,stage", [("word_edges_s", "graph.word_edges"),
                                        ("csr_plan_s", "operator.csr_plan")])
def test_stage_readers_take_the_newest_record(monkeypatch, name, stage):
    read = harness.metric_reader(name)
    recs = collections.deque([profiling.Stage(stage, 10.0, 11.5),
                              profiling.Stage("graph.tfidf", 11.5, 20.0),
                              profiling.Stage(stage, 30.0, 32.25, parent="t.parent")])
    monkeypatch.setattr(profiling, "_STAGES", recs)
    assert read(None) == pytest.approx(2.25)
    monkeypatch.setattr(profiling, "_STAGES", collections.deque())
    assert read(None) is None
    # a program without stages (the module without ``stages``)
    monkeypatch.delattr(profiling, "stages")
    assert read(None) is None


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
def test_each_csr_launch_has_one_span_before_its_kernel(cuda, graph, tmp_path):
    from pytextgcn_tpu_torch.ops import spmm_cuda

    model = GCN(graph.in_dim, 3, n_hidden_gcn=8, dropout=0.5,
                generator=torch.Generator().manual_seed(2)).to(cuda)
    trainer = Trainer(model, lr=0.05, device=cuda)
    trainer.fit(graph, epochs=1, n_classes=3)  # builds the kernel and the operator
    torch.cuda.synchronize()
    launches = spmm_cuda.spmm_csr_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit(graph, epochs=3, n_classes=3)
        torch.cuda.synchronize()
    launches = spmm_cuda.spmm_csr_kernel.launches - launches
    events = _events(prof, tmp_path)
    spans = _spans(events, "spmm.launch")
    kernels = sorted((ev for ev in events if ev.get("cat") == "kernel"
                      and "spmm_segments_kernel" in ev["name"]), key=lambda ev: ev["ts"])
    assert launches == 18 and len(spans) == launches and len(kernels) == launches
    # the kernel of each span: by the correlation id of the runtime's launch
    # inside it where the trace links them, else in order
    by_corr = {ev["args"].get("correlation"): ev for ev in kernels}
    runtime = [ev for ev in events if ev.get("cat") in ("cuda_runtime", "cuda_driver")
               and "aunch" in ev["name"]]
    for k, span in enumerate(spans):
        linked = [by_corr[ev["args"].get("correlation")] for ev in runtime
                  if ev["tid"] == span["tid"] and _inside(ev, span)
                  and ev["args"].get("correlation") in by_corr]
        kernel = linked[0] if linked else kernels[k]
        assert kernel["ts"] >= span["ts"], (k, span, kernel)
