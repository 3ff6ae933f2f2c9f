"""One run of one cell: set-up, the timed window, the comparison, the result.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the cell's
configuration and traffic, whose files are ``configs/<config>.json`` and
``traffic/<traffic>.json``; the traffic's ``loop`` is ``loops/<loop>.py``, the
configuration's model kind ``models/<kind>.py``; the cell's limits are
``limits/<cell>.json``; each metric is read by ``metrics/<metric>.py``'s
``read(run)``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import check, corpus, program, tracing, weights
from .reference import graph as ref_graph

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "pytextgcn_tpu")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_cell(name: str, root: str = ROOT) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json`` with its files under
    ``<root>/benchmark``, and the metrics it reports: those that list it
    under ``workloads``, or list no cells."""
    spec = load_json(root, "BENCHMARK.json")
    by_name = {w["name"]: w for w in spec["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    w = by_name[name]
    bench = os.path.join(root, "benchmark")
    mine = lambda ms: [m for m in ms if name in m.get("workloads", [name])]
    return Cell(name=name, chips=int(w["chips"]),
                config=load_json(bench, "configs", f"{w['config']}.json"),
                traffic=load_json(bench, "traffic", f"{w['traffic']}.json"),
                limits=load_json(bench, "limits", f"{name}.json"),
                end_to_end=mine(spec["end_to_end"]), per_layer=mine(spec["per_layer"]))


def metric_reader(name: str, root: str = ROOT) -> Callable:
    """``read`` of ``<root>/benchmark/metrics/<name>.py`` (loaded by path:
    names may hold dots)."""
    path = os.path.join(root, "benchmark", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    config: dict
    traffic: dict
    n_nodes: int
    n_edges: int  # edges of the graph, self-loops not included
    n_classes: int
    setup_s: float
    epoch_s: List[float]  # every epoch of the window, end to end
    timers: Dict[str, float]
    trace: Optional[tracing.TraceWindow] = None
    traced_launches: Optional[int] = None  # CSR launches in the traced epochs
    untraced_epoch_s: Optional[List[float]] = None  # the epochs the profiler was off for


class Profiler:
    """Profiles epochs ``after + 1 .. after + n`` of the window and marks each
    epoch end inside them on the trace."""

    def __init__(self, after: int, n: int, device: torch.device):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.after, self.n = after, n
        self.launches = [None, None]
        self.running = False

    def _mark(self) -> None:
        with torch.profiler.record_function(tracing.EPOCH_MARK):
            pass

    def __call__(self, k: int) -> None:
        if k == self.after:
            self.prof.start()
            self.running = True
            self.launches[0] = program.csr_launches()
            self._mark()
        elif self.running:
            self._mark()
            if k == self.after + self.n:
                self.stop()
                self.launches[1] = program.csr_launches()

    def stop(self) -> None:
        if self.running:
            self.prof.stop()
            self.running = False

    def window(self) -> Optional[tracing.TraceWindow]:
        if self.launches[1] is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            return tracing.TraceWindow.load(path)
        finally:
            os.remove(path)


def load_loop(name: str):
    """The loop module ``loops/<name>.py``."""
    return importlib.import_module(f"benchmark.loops.{name}")


def program_graph(g, adj) -> dict:
    """The program's graph and ``A_hat``, on the host."""
    return {**program.graph_arrays(g), "norm_w": adj.w.cpu().numpy(),
            "self_w": adj.self_w.cpu().numpy()}


def make_graph(cell: Cell, seed: int, n_docs: int = 0):
    """The corpus and split from the seed, and the program's graph of them:
    ``(inputs, n_classes, g, graph_build_s)``. ``n_docs``: a smaller corpus
    than the configuration's (tests only)."""
    cfg = cell.config
    program.set_precision(cfg["precision"])
    inputs = corpus.make_inputs(cfg["data"], seed, n_docs)
    t = time.perf_counter()
    g = program.build_graph(cfg["graph"], *inputs)
    return inputs, corpus.class_count(cfg["data"]), g, time.perf_counter() - t


def reference_graph(cell: Cell, inputs, device: torch.device) -> dict:
    """The reference's graph and ``A_hat`` from the benchmark's inputs."""
    graph = ref_graph.build_graph(*inputs, cell.config["graph"], device)
    graph["norm_w"], graph["self_w"] = ref_graph.normalize(graph)
    return graph


def readings(loop, prog_graph: dict, compared: dict, ref_g: dict,
             ref: dict) -> Dict[str, float]:
    """Every number the check can compare: the graph's and the loop's."""
    return {**check.compare_graph(prog_graph, ref_g), **loop.compare(compared, ref)}


def card_info(device: torch.device) -> List[str]:
    """The card's name, power limit and clocks, as ``nvidia-smi`` reads them."""
    import subprocess

    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem,temperature.gpu"
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return [f"card: {out}"] if out else []


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             process_start: float, n_docs: int = 0, log=print) -> dict:
    """One run; returns the result object (the last line's)."""
    traffic = cell.traffic
    inputs, n_classes, g, graph_build_s = make_graph(cell, seed, n_docs)
    loop = load_loop(traffic["loop"])
    profiler = (Profiler(int(traffic["trace_after_epochs"]), int(traffic["trace_epochs"]),
                         device) if trace else None)
    out = loop.run(cell, g, n_classes, seed, seconds, [profiler] if profiler else [], device)
    if profiler is not None:
        profiler.stop()
    times = out["times"]
    setup_s = out["t0"] - process_start
    epoch_s = list(np.diff([out["t0"]] + times))
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    prog_graph = program_graph(g, out["adj"])
    n_nodes, n_edges = g.n_nodes, len(prog_graph["src"])
    run = Run(config=cell.config, traffic=traffic, n_nodes=n_nodes, n_edges=n_edges, n_classes=n_classes,
              setup_s=setup_s, epoch_s=epoch_s,
              timers=dict(out["timers"], graph_build_s=graph_build_s))
    if profiler is not None:
        run.trace = profiler.window()
        if run.trace is not None:
            run.traced_launches = profiler.launches[1] - profiler.launches[0]
            a, b = profiler.after + 1, profiler.after + profiler.n + 1
            run.untraced_epoch_s = epoch_s[:a - 1] + epoch_s[b:]
    compared, failed = out["compared"], out["failed"]
    del out, g
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # the comparison, once the program's state is freed
    ref_g = reference_graph(cell, inputs, device)
    params = weights.initial_params(cell.config["model"], n_nodes, n_classes, seed, device)
    ref = loop.reference(cell, ref_g, params, compared, seed, device)
    judged = check.judge(readings(loop, prog_graph, compared, ref_g, ref), cell.limits)
    correct = failed == 0 and len(times) > 0 and all(c["ok"] for c in judged.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(times), "failed": failed,
              "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_us() / 1e6
        dev["window_s"] = run.trace.window_us / 1e6
        result["breakdown"] = {
            "device_ops": tracing.top(run.trace.device_us_by_name().items()),
            "idle_gaps": tracing.top(run.trace.idle_gaps()),
        }
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in judged.items()}

    if device.type == "cuda":
        for line in card_info(device):
            log(line, file=sys.stderr)
    log(f"cell {cell.name} seed {seed}: N={n_nodes} E={n_edges} epochs={len(times)} "
        f"setup_s={setup_s} peak_bytes={peak} timers={run.timers} "
        f"csr_launches_traced={run.traced_launches}", file=sys.stderr)
    for k, c in judged.items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r} {'ok' if c['ok'] else 'FAILED'}",
            file=sys.stderr)
    return result


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))

