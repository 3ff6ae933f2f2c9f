"""The port's profiling (``train/profiling.py``), probe (``ops/probe.py``)
and floor accounting (``floor_spmm_ns`` of ``ops/hybrid.py`` and
``ops/restricted.py``) against the JAX package's. On the CPU the probe's
readings are the CPU's: these tests hold its arithmetic, not its numbers."""

import json
import math

import numpy as np
import pytest
import torch

from pytextgcn_tpu.ops import probe as jax_probe
from pytextgcn_tpu_torch.core.graph import TextGraph
from pytextgcn_tpu_torch.ops import hybrid, probe
from pytextgcn_tpu_torch.ops.hybrid import build_hybrid_plan, plan_floor_ns
from pytextgcn_tpu_torch.ops.restricted import build_restricted_adj
from pytextgcn_tpu_torch.train import profiling


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: the suite runs several workers on a few cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_stage_timer_records_and_sums():
    # stages replace the timer: records on perf_counter, nested ones inside
    # their parent, each stage's seconds summing within the enclosing one
    with profiling.stage("t.build"):
        with profiling.stage("t.count"):
            pass
        with profiling.stage("t.count"):
            pass
    recs = [r for r in profiling.stages() if r.name.startswith("t.")][-3:]
    assert [(r.name, r.parent) for r in recs] == [
        ("t.count", "t.build"), ("t.count", "t.build"), ("t.build", None)]
    build = recs[2]
    assert all(build.start <= r.start <= r.end <= build.end for r in recs[:2])
    assert sum(r.seconds for r in recs[:2]) <= build.seconds


def test_trace_writes_a_chrome_trace_on_cpu(tmp_path):
    with profiling.trace(str(tmp_path), name="t") as prof:
        a = torch.randn(64, 64)
        (a @ a).sum()
    events = json.loads(open(prof.trace_path).read())["traceEvents"]
    assert prof.trace_path.endswith("t.json") and events
    # no card: no kernel, memcpy or memset span, so no device time
    assert profiling.device_busy_us(prof.trace_path) == 0.0


def test_device_busy_is_the_union_of_device_spans(tmp_path):
    path = tmp_path / "trace.json"
    events = [{"cat": "kernel", "ts": 0, "dur": 10}, {"cat": "kernel", "ts": 5, "dur": 10},
              {"cat": "gpu_memcpy", "ts": 30, "dur": 5}, {"cat": "cpu_op", "ts": 0, "dur": 100},
              {"cat": "gpu_memset", "ts": 31, "dur": 1}]
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling.device_busy_us(str(path)) == 20.0


def _fake_clock(monkeypatch, t_short, t_long):
    # each timed run reads the clock twice; consecutive runs' readings are
    # apart by the same amount, which no difference sees
    ticks = iter(np.cumsum([0.0, t_short, t_short, t_long, t_long]).tolist())

    class FakeTime:  # replaces only probe.py's module-level `time` binding
        perf_counter = staticmethod(lambda: next(ticks))

    monkeypatch.setattr(probe, "time", FakeTime)


def test_slope_time_cancels_constant_overhead(monkeypatch):
    per_iter, overhead = 1e-3, 50e-3
    calls = []

    def make_fn(length):
        return (lambda: calls.append(length)), ()

    _fake_clock(monkeypatch, overhead + 8 * per_iter, overhead + 40 * per_iter)
    got, fell_back = probe.slope_time(make_fn, reps=1)
    np.testing.assert_allclose(got, per_iter, rtol=1e-9)
    assert not fell_back
    assert calls == [8, 8, 40, 40]  # warm-up + 1 rep per length


def test_slope_time_falls_back_and_says_so(monkeypatch):
    # the long chain timed faster than the short one: pure noise
    _fake_clock(monkeypatch, 0.5, 0.1)
    got, fell_back = probe.slope_time(lambda n: ((lambda: None), ()), reps=1)
    assert fell_back and got == pytest.approx(0.1 / 40)


CEILINGS = dict(gather_ns=0.3, hbm_bps=2.5e12, mxu_f32_fps=5e13, mxu_bf16_fps=6e14,
                stream_bps=2.8e12)


class _Plan:
    """A HybridPlan's fields, for the probe's formula."""

    def __init__(self, compute_dtype="float32", fused=False, split=False):
        self.n_nodes, self.k, self.n_resid = 77_923, 4096, 1_550_390
        self.compute_dtype, self.fused = compute_dtype, fused
        self.d_lo = object() if split else None


@pytest.mark.parametrize("h", [100, 43, 512])
@pytest.mark.parametrize("port,jax", [
    (dict(), dict()),  # f32 'highest', two torch.mm: D read twice
    (dict(fused=True), dict(fused=True)),  # the f32 dual kernel: once
    # bf16 D runs in the dual kernel whether or not fused is set: JAX's
    # fused bf16 plan is its counterpart
    (dict(compute_dtype="bfloat16"), dict(compute_dtype="bfloat16", fused=True)),
    (dict(split=True), dict(split=True)),  # D as a hi/lo pair, 3 bf16 passes
], ids=["f32", "f32-fused", "bf16", "split"])
def test_probe_floor_equals_jax_probe(port, jax, h):
    mine = probe.ChipProbe(probe_s=0.1, **CEILINGS)
    # the JAX form prices a residual edge at its gather rate; the port at
    # the 8 bytes of index and weight it must read, at the stream rate
    assert mine.resid_edge_ns == 8 / CEILINGS["stream_bps"] * 1e9
    ref = jax_probe.ChipProbe(probe_s=0.1, **dict(CEILINGS, gather_ns=mine.resid_edge_ns))
    plan = _Plan(**jax)
    assert mine.hybrid_floor_ns(_Plan(**port), h) == ref.hybrid_floor_ns(plan, h)
    for itemsize, d_reads, passes in ((4, 2, 0), (2, 1, 0), (4, 1, 3)):
        assert (mine.dense_ns(77_923, 4096, h, itemsize, d_reads, passes)
                == ref.dense_ns(77_923, 4096, h, itemsize, d_reads, passes))


def test_probe_runs_on_the_cpu():
    pr = probe.probe_chip(device="cpu", e=100_000, nk=4_096, reps=1, chain=(2, 4))
    for v in (pr.gather_ns, pr.gather_copy_ns, pr.hbm_bps, pr.stream_bps, pr.mxu_f32_fps,
              pr.mxu_tf32_fps, pr.mxu_bf16_fps, pr.probe_s):
        assert v > 0 and math.isfinite(v)
    assert pr.device == "cpu" and set(pr.fallbacks) <= {"gather", "gather_copy", "stream",
                                                         "d_read", "tf32", "f32", "bf16"}


def _graph(n=400, m=4000, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, n, m).astype(np.int32)
    b = rng.integers(0, n, m).astype(np.int32)
    w = (rng.random(m) + 0.1).astype(np.float32)
    zeros = np.zeros(n, bool)
    return TextGraph(edge_src=np.concatenate([a, b]), edge_dst=np.concatenate([b, a]),
                     edge_w=np.concatenate([w, w]), y=np.zeros(n, np.int32),
                     train_mask=zeros, val_mask=zeros, test_mask=zeros,
                     n_vocab=n // 2, n_docs=n - n // 2)


def _port_probe():
    """The probe's ceilings set to the port's constants."""
    return probe.ChipProbe(gather_ns=0.0, hbm_bps=hybrid._HBM_BPS,
                           mxu_f32_fps=hybrid._MXU_F32_HIGHEST,
                           mxu_bf16_fps=hybrid._MXU_BF16_FACTOR * hybrid._MXU_F32_HIGHEST,
                           probe_s=0.1, stream_bps=hybrid._STREAM_BPS)


@pytest.mark.parametrize("fused", [False, True])
def test_plan_floor_equals_the_probe_formula_at_the_port_constants(fused):
    # at H = 128 the f32 pair is flop-bound, where the JAX plan's floor
    # (the K x K term added) and the probe's (inside the max) agree
    g = _graph()
    plan = build_hybrid_plan(g.edge_src, g.edge_dst, g.edge_w, g.n_nodes, hot_k=64,
                             f32_mode="highest", fused=fused)
    assert plan.n_resid > 0
    want = _port_probe().hybrid_floor_ns(plan, 128)
    np.testing.assert_allclose(plan.floor_spmm_ns, want, rtol=1e-12)
    # no _HYBRID_NH_NS term: the dense pair at zero residual plus the gathers
    dense = hybrid._predict_cost_ns(plan.n_nodes, 0, 0, plan.k, 128, 4,
                                    d_reads=1 if fused else 2) \
        - hybrid._HYBRID_NH_NS * plan.n_nodes * 128
    np.testing.assert_allclose(plan.floor_spmm_ns, dense + plan.n_resid * hybrid._GATHER_NS,
                               rtol=1e-9)
    # at the other flop-bound widths too
    for h in (100, 512):
        np.testing.assert_allclose(plan_floor_ns(plan, h),
                                   _port_probe().hybrid_floor_ns(plan, h), rtol=1e-12)
    # a wider head can only raise the floor
    assert plan_floor_ns(plan, 512) >= plan.floor_spmm_ns >= plan_floor_ns(plan, 100)


@pytest.mark.parametrize("hot_k", [None, 128])
def test_restricted_floor_equals_the_probe_formula(hot_k):
    g = _graph()
    rows = np.arange(g.n_vocab, g.n_nodes)
    adj = build_restricted_adj(g, rows, use_pallas=True, hot_k=hot_k, device="cpu")
    assert 0 < adj.n_resid <= adj.n_edges and (hot_k or adj.n_resid == adj.n_edges)
    # the JAX package's restricted floor: the [M, K] slab read once, the
    # residual at the floor's price an edge
    pr = _port_probe()
    slab = adj.m * adj.k * 4 / pr.hbm_bps * 1e9
    np.testing.assert_allclose(adj.floor_spmm_ns, slab + adj.n_resid * pr.resid_edge_ns,
                               rtol=1e-12)
    if not hot_k:
        assert adj.floor_spmm_ns == adj.n_edges * hybrid._GATHER_NS


def test_the_residual_floor_is_below_the_csr_kernels_edge():
    # a floor the kernel that runs the residual beats is no floor: the price
    # of a residual edge lies below the CSR kernel's measured edge at every
    # width of its table, and is the probe's formula at the port's stream rate
    assert hybrid._GATHER_NS == pytest.approx(_port_probe().resid_edge_ns, rel=1e-12)
    assert hybrid._GATHER_NS < min(hybrid._CSR_EDGE_NS.values())
    for h in (1, 43, 100, 600):
        assert hybrid._GATHER_NS < hybrid.csr_edge_ns(h)


def test_cached_plan_carries_the_same_floor(tmp_path):
    from pytextgcn_tpu_torch.ops import NormAdj

    g = _graph(seed=1)
    kw = dict(hybrid_k=128, device="cpu", plan_cache=str(tmp_path), h_hint=100)
    cold = NormAdj.from_graph(g, **kw).plan
    warm = NormAdj.from_graph(g, **kw).plan
    assert cold.floor_spmm_ns == warm.floor_spmm_ns == plan_floor_ns(cold, 100)
