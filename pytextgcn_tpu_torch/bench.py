"""Benchmark: full-batch TextGCN training-step throughput on one card.

The port's counterpart of the JAX package's ``bench.py`` at the root of the
repository (which stays the JAX package's):

    python -m pytextgcn_tpu_torch.bench                      # the card
    python -m pytextgcn_tpu_torch.bench --profile OUT_DIR    # + busy / idle
    python -m pytextgcn_tpu_torch.bench --device cpu --scales 300 --epochs 2

It times the train step the port's ``Trainer`` runs (2-layer GCN, hidden
100, 43 classes, dropout 0.5, forward, masked cross-entropy, backward,
``Adam(amsgrad=True)`` at lr 0.05, TF32 off) on graphs built by the port's
own pipeline: ``Text2Graph`` over a Zipfian corpus (8,000 and 20,000
documents, the JAX bench's corpus value for value) and the 50k-document
synthetic-amazon protocol graph (``protocol``). Each variant of the JAX
bench runs: the segment path, the CSR kernel, and the hybrid in f32
'split2', f32 'highest' and bf16, each with and without the masked head, at
``hybrid_k='auto'`` and at an explicit K = 4096 (on an H100 'auto' mostly
declines the hot set, and its f32 'highest' pair runs in two ``torch.mm``,
so the explicit K is what runs each dual kernel; the explicit-K 'highest'
variants set ``hybrid_fused`` on, the f32 dual kernel). Each variant reports
the K it ran (``hybrid_k``, 0 for the CSR kernel alone).

Timing: 5 warm-up steps, then 3 blocks of ``--epochs`` steps, each block
ending in a synchronize; the median block and ``[min, median, max]``. On the
card each variant's kernel launches a step are counted and must equal what
its plans imply.

Headline (the JAX bench's, with the card's numbers): the fastest f32 path
at the last scale in edge traversals a second; its roofline, the step's
ideal bytes over the H100's 3.35 TB/s (and over the probe's stream rate);
the probed ceilings (``ops/probe.py``) and the probed floor of the f32
hybrid step; the plan cache cold then warm. Unlike the JAX bench, nothing
is swallowed: a variant that fails stops the run, and a roofline or floor
fraction above 1.05 (or a probed floor above the step, ``floor_check``)
is printed and exits nonzero. With ``--profile`` the floors are also held
against the floor path's device busy time (``*_busy`` fractions).

Prints exactly one JSON line on stdout; progress goes to stderr.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .train.profiling import H100_PEAK

N_HIDDEN = 100
N_CLASSES = 43  # Amazon Cat2
EPOCHS_MEASURED = 20
WARMUP_STEPS = 5
TIMING_BLOCKS = 3  # independent timed blocks per variant (spread reporting)
SCALES = ["8000", "20000", "protocol"]  # Zipf corpus sizes (docs), the 50k protocol graph
EXPLICIT_K = 4096
PEAK_HBM_BPS = H100_PEAK["hbm_gbps"] * 1e9
FRACTION_LIMIT = 1.05  # a roofline or floor fraction above this is a fault
FLOOR_SLACK = 1.02  # the JAX bench's floor_check margin
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_CACHE = os.path.join(ROOT, ".plan_cache")  # listed in .gitignore


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def zipf_corpus(n_docs, v_draw=40_000, alpha=1.05, seed=0):
    """Zipf-distributed corpus: real hub-word structure for Text2Graph."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, v_draw + 1) ** alpha
    cum = np.cumsum(p / p.sum())
    docs = []
    lengths = np.clip(np.exp(rng.normal(4.0, 0.6, n_docs)).astype(int), 5, 400)
    for i in range(n_docs):
        idx = np.searchsorted(cum, rng.random(lengths[i])).clip(0, v_draw - 1)
        docs.append(" ".join(f"w{j}" for j in idx))
    return docs


def build_graph(n_docs, device=None):
    """The JAX bench's graph: ``Text2Graph(min_df=5, window_size=20)`` over
    :func:`zipf_corpus`, with labels spread over ``N_CLASSES`` and the first
    70% of the documents as the train rows."""
    from .build.text2graph import Text2Graph

    docs = zipf_corpus(n_docs)
    t0 = time.time()
    t2g = Text2Graph(min_df=5, window_size=20, rm_stopwords=False, device=device)
    g = t2g.fit_transform(docs, [0] * len(docs))
    # the generator gives one class: spread labels so the loss and metrics
    # do real work
    rng = np.random.default_rng(1)
    n = g.n_nodes
    train_mask = np.zeros(n, bool)
    train_mask[g.n_vocab: g.n_vocab + int(g.n_docs * 0.7)] = True
    g = dataclasses.replace(g, y=rng.integers(0, N_CLASSES, n).astype(np.int32),
                            train_mask=train_mask)
    log(f"graph(docs={n_docs}): N={g.n_nodes} (vocab {g.n_vocab}) "
        f"E={g.n_edges} built in {time.time() - t0:.0f}s")
    return g


def protocol_graph(device=None, n_docs: int = 50_000):
    """The flat experiment's synthetic-amazon graph at its defaults
    (``--dataset synthetic-amazon``; at 50,000 documents N = 77,923 and
    E = 13,310,312, the graph chip_smoke.py drives), with its own 43-class
    labels and 36,000 train documents."""
    from .config import parse_config
    from .experiments import common

    t0 = time.time()
    cfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", str(n_docs)])
    docs, labels, test_idx, val_idx = common.load_corpus(cfg)
    g = common.build_graph(cfg.graph, docs, labels[0], test_idx, val_idx, verbose=0,
                           device=device)
    log(f"graph(synthetic-amazon, docs={n_docs}): N={g.n_nodes} (vocab {g.n_vocab}) "
        f"E={g.n_edges} built in {time.time() - t0:.0f}s")
    return g


def variants(plan_cache: Optional[str]) -> List[Tuple[str, dict]]:
    """The JAX bench's variants that the port has, each at ``'auto'`` K and
    at ``EXPLICIT_K``. ``csr f32`` is the JAX bench's ``pallas f32``."""
    out = [("segment f32", dict(use_pallas=False)), ("csr f32", dict())]
    modes = (("hybrid f32", dict(hybrid_f32_mode="split2")),
             ("hybrid f32.highest", dict(hybrid_f32_mode="highest")),
             ("hybrid bf16", dict(pallas_dtype="bfloat16")))
    for k, tag in (("auto", ""), (EXPLICIT_K, f" K{EXPLICIT_K}")):
        for name, kw in modes:
            kw = dict(kw, hybrid_k=k, plan_cache=plan_cache)
            if k != "auto" and name == "hybrid f32.highest":
                kw["hybrid_fused"] = True  # the f32 dual kernel, not two torch.mm
            out.append((name + tag, kw))
            out.append((name + tag + " masked-head", dict(kw, masked_head=True)))
    return out


def _counts() -> dict:
    from .ops import fused_dual, spmm_cuda

    return {"spmm_csr": spmm_cuda.spmm_csr_kernel.launches,
            "dual": dict(fused_dual.fused_dual_kernel.launches)}


def _reset_counts() -> None:
    from .ops import fused_dual, spmm_cuda

    spmm_cuda.spmm_csr_kernel.launches = 0
    fused_dual.fused_dual_kernel.launches = {}


def expected_launches(adj, adj_out) -> dict:
    """Kernel launches a train step implies from its operators: each SpMM
    application launches once forward and once backward; two applications
    run on the full operator (four without the masked head), two on the
    masked head's. A hybrid application launches the dual kernel (unless
    its f32 pair runs in two ``torch.mm``) and the CSR kernel on its
    residual; the masked head's hot slab is a ``torch.matmul``."""
    from .ops.hybrid import HybridPlan

    out = {"spmm_csr": 0, "dual": {}}
    full = 2 if adj_out is not None else 4
    plan = adj.plan
    if isinstance(plan, HybridPlan):
        if plan.d_lo is not None:
            variant = "split"
        elif plan.compute_dtype == "bfloat16":
            variant = "bf16"
        else:
            variant = "f32" if plan.fused else None
        if variant:
            out["dual"][variant] = full
        if plan.res is not None:
            out["spmm_csr"] += full
    elif plan is not None:
        out["spmm_csr"] += full
    if adj_out is not None and adj_out.res is not None:
        out["spmm_csr"] += 2
    return out


def time_step(step, repeats: int, sync, blocks: int = TIMING_BLOCKS):
    """``WARMUP_STEPS`` steps, then ``blocks`` blocks of ``repeats`` steps,
    each ending in a loss read and ``sync()``. Returns (median s a step,
    sorted block times, the last loss)."""
    for _ in range(WARMUP_STEPS):
        loss = step()
    float(loss)
    sync()
    times = []
    for _ in range(blocks):
        t0 = time.perf_counter()
        for _ in range(repeats):
            loss = step()
        final = float(loss)
        sync()
        times.append((time.perf_counter() - t0) / repeats)
    times.sort()
    return times[len(times) // 2], times, final


def bench_scale(g, variant_list, device, epochs: int = EPOCHS_MEASURED,
                profile_dir: Optional[str] = None, tag: str = "",
                profile_names=None) -> dict:
    """Time every variant's train step on ``g``. Returns per-variant step
    seconds (``step_s``), block spreads, operator build seconds, the K each
    hybrid variant runs (0: the CSR kernel), floors, the launches a step
    (on the card, checked against :func:`expected_launches`), the plans and,
    with ``profile_dir``, device busy ms and idle share (of the variants in
    ``profile_names``, all when it is None)."""
    from .models import GCN
    from .ops.hybrid import HybridPlan, plan_floor_ns
    from .train.profiling import device_busy_us, trace
    from .train.trainer import Trainer

    on_card = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if on_card else (lambda: None)
    n_classes = int(np.max(np.asarray(g.y))) + 1
    out = {k: {} for k in ("step_s", "spread", "build_s", "hybrid_k", "floor_ns",
                           "launches_per_step", "expected_launches", "loss", "busy")}
    out["plans"] = {}
    for name, kwargs in variant_list:
        model = GCN(g.in_dim, n_classes, n_hidden_gcn=N_HIDDEN, dropout=0.5,
                    generator=torch.Generator().manual_seed(0))
        trainer = Trainer(model, lr=0.05, seed=1, device=device, **kwargs)
        t0 = time.perf_counter()
        adj, feats = trainer.prepare(g)
        y = torch.as_tensor(np.asarray(g.y), dtype=torch.int64, device=device)
        mask = torch.as_tensor(np.asarray(g.train_mask), device=device)
        adj_out = None
        if trainer.masked_head:
            adj_out = trainer._prepare_restricted(g)
            y, mask = y.index_select(0, adj_out.rows), torch.ones(
                adj_out.m, dtype=torch.bool, device=device)
        sync()
        build_s = time.perf_counter() - t0
        step = lambda: trainer._train_step(adj, feats, y, mask, adj_out)
        _reset_counts()
        dt, dts, loss = time_step(step, epochs, sync)
        n_steps = WARMUP_STEPS + TIMING_BLOCKS * epochs
        got = _counts()
        per_step = {"spmm_csr": got["spmm_csr"] / n_steps,
                    "dual": {k: v / n_steps for k, v in got["dual"].items()}}
        want = expected_launches(adj, adj_out)
        if on_card and per_step != want:
            raise RuntimeError(f"{name}: kernel launches a step {per_step}, its plans imply "
                               f"{want}")
        if not np.isfinite(loss):
            raise FloatingPointError(f"{name}: loss {loss}")
        plan = adj.plan
        hybrid = isinstance(plan, HybridPlan)
        if "hybrid_k" in kwargs:
            out["hybrid_k"][name] = plan.k if hybrid else 0
        if hybrid:
            # the step's four applications: two at the hidden width, two at
            # the classes' (on the masked head's operator when it is on)
            head = (2 * adj_out.floor_spmm_ns if adj_out is not None
                    else 2 * plan_floor_ns(plan, n_classes))
            out["floor_ns"][name] = 2 * plan_floor_ns(plan, N_HIDDEN) + head
            out["plans"][name] = plan
        out["step_s"][name] = dt
        out["spread"][name] = dts
        out["build_s"][name] = build_s
        out["launches_per_step"][name] = per_step
        out["expected_launches"][name] = want
        out["loss"][name] = loss
        profiled = profile_dir and (profile_names is None or name in profile_names)
        if profiled:
            with trace(profile_dir, name=f"trace_{tag}_{name.replace(' ', '_')}") as prof:
                for _ in range(5):
                    step()
                sync()
            busy_ms = device_busy_us(prof.trace_path) / 5 / 1e3
            out["busy"][name] = {"busy_ms": busy_ms, "idle": 1 - busy_ms / (dt * 1e3)}
        log(f"  {name}: {dt * 1e3:.3f} ms/step "
            f"[{dts[0] * 1e3:.3f}-{dts[-1] * 1e3:.3f} over {len(dts)} blocks] "
            f"({4 * g.n_edges / dt / 1e9:.3f} G edge-trav/s; build {build_s:.1f}s; "
            f"K {out['hybrid_k'].get(name, '-')}; launches a step {per_step}; loss {loss:.4f})"
            + (f"; busy {out['busy'][name]['busy_ms']:.3f} ms, idle "
               f"{out['busy'][name]['idle']:.1%}" if profiled else ""))
        del trainer, adj, adj_out, feats, step
        if on_card:
            torch.cuda.empty_cache()
    return out


def card_session(device) -> dict:
    """torch, CUDA, the card and its power limit (nvidia-smi)."""
    sess = {"torch": torch.__version__, "cuda": torch.version.cuda}
    if device.type != "cuda":
        return dict(sess, device="cpu", power_limit=None, devices=0)
    res = subprocess.run(["nvidia-smi", "-i", str(device.index or 0),
                          "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    name, limit = (s.strip() for s in res.stdout.strip().splitlines()[0].split(","))
    return dict(sess, device=torch.cuda.get_device_name(device), nvidia_smi=name,
                power_limit=limit, devices=torch.cuda.device_count())


def floor_path(res: dict) -> Optional[str]:
    """The variant whose floors headline: the full-output f32 hybrid step,
    at ``'auto'`` if it chose a hot set, else at the explicit K."""
    return next((n for n in ("hybrid f32", f"hybrid f32 K{EXPLICIT_K}") if n in res["plans"]),
                None)


def headline(g, res: dict, small: dict, probe, device, plan_fields: dict,
             scales: list) -> dict:
    """The JAX bench's output line from the last scale's results ``res``.
    Where ``res`` holds the floor path's device busy time (``--profile``),
    the floors are held against it as well as against the host's step."""
    times = res["step_s"]
    seg_dt = times.get("segment f32")
    f32 = {k: v for k, v in times.items() if "f32" in k}
    best_name, best_dt = min((f32 or times).items(), key=lambda kv: kv[1])
    # the masked-head step computes less: it headlines only when it gains
    # at least 10% over the full step
    if best_name.endswith("masked-head"):
        full_name = best_name.replace(" masked-head", "")
        if full_name in times and times[full_name] / best_dt < 1.10:
            best_name, best_dt = full_name, times[full_name]
    traversals = 4 * g.n_edges
    # ideal streaming traffic of the step's 4 SpMMs: x read once, out written
    # once, the edge list once each
    ideal_bytes = 4 * (2 * g.n_nodes * N_HIDDEN * 4 + g.n_edges * 8)
    fraction = ideal_bytes / PEAK_HBM_BPS / best_dt
    x_of_gather_floor = traversals * probe.gather_ns * 1e-9 / best_dt
    frac_name = floor_path(res)
    fields = {}
    if frac_name is not None:
        plan, step_s = res["plans"][frac_name], times[frac_name]
        floor_s = res["floor_ns"][frac_name] * 1e-9
        floor_probed_s = (2 * probe.hybrid_floor_ns(plan, N_HIDDEN)
                          + 2 * probe.hybrid_floor_ns(plan, N_CLASSES)) * 1e-9
        # the step the floors are held against: the host's, and the
        # device's busy time where it was profiled (the tighter one)
        held = {"": step_s}
        busy = res["busy"].get(frac_name)
        if busy:
            held["_busy"] = busy["busy_ms"] * 1e-3
        fields = {"floor_path": frac_name}
        for suffix, t in held.items():
            fields[f"fraction_of_achievable{suffix}"] = round(floor_s / t, 4)
            fields[f"fraction_of_achievable_probed{suffix}"] = round(floor_probed_s / t, 4)
        fields["floor_check"] = ("ok" if floor_probed_s <= min(held.values()) * FLOOR_SLACK
                                 else "VIOLATED")
        log(f"probed floor {floor_probed_s * 1e3:.3f} ms, frozen {floor_s * 1e3:.3f} ms vs "
            f"step {step_s * 1e3:.3f} ms"
            + (f", busy {busy['busy_ms']:.3f} ms" if busy else "")
            + f" ({frac_name}, K={plan.k}, {plan.n_resid} residual edges)")
    masked_speedup = (round(times["hybrid f32"] / times["hybrid f32 masked-head"], 3)
                      if "hybrid f32" in times and "hybrid f32 masked-head" in times else None)
    log(f"best f32 path at the last scale: {best_name} ({traversals / best_dt / 1e9:.3f} G "
        f"edge-trav/s, {fraction:.1%} of the 3.35 TB/s roofline)")
    return {
        "metric": "gcn_train_step_edge_traversals_per_s",
        "value": round(traversals / best_dt, 1),
        "unit": "edges/s",
        "vs_baseline": round(seg_dt / best_dt, 3) if seg_dt else 1.0,
        "fraction_of_roofline": round(fraction, 4),
        "fraction_of_achievable": fields.pop("fraction_of_achievable", None),
        "probed_gather_ns": round(probe.gather_ns, 4),
        "probed_gather_copy_ns": round(probe.gather_copy_ns, 4),
        "probed_hbm_bps": round(probe.hbm_bps, 1),
        "probed_stream_bps": round(probe.stream_bps, 1),
        "fraction_of_roofline_probed": round(ideal_bytes / probe.stream_bps / best_dt, 4),
        "probed_mxu_f32_fps": round(probe.mxu_f32_fps, 1),
        "probed_mxu_tf32_fps": round(probe.mxu_tf32_fps, 1),
        "probed_mxu_bf16_fps": round(probe.mxu_bf16_fps, 1),
        "probe_fallbacks": list(probe.fallbacks),
        "probe_s": round(probe.probe_s, 1),
        **fields,
        **plan_fields,
        "masked_head_speedup": masked_speedup,
        "hybrid_k": res["hybrid_k"],
        "x_of_gather_floor": round(x_of_gather_floor, 3),
        "best_path": best_name,
        "graph": {"n_nodes": g.n_nodes, "n_edges": g.n_edges, "built_by": "Text2Graph"},
        "step_ms": {k: round(v * 1e3, 4) for k, v in times.items()},
        "step_ms_spread": {k: [round(t * 1e3, 4) for t in v] for k, v in res["spread"].items()},
        "timing_blocks": TIMING_BLOCKS,
        "step_ms_small": {k: round(v * 1e3, 4) for k, v in small["step_s"].items()},
        "launches_per_step": res["launches_per_step"],
        "scales": scales,
        "session": card_session(device),
    }


def check_fractions(out: dict) -> List[str]:
    """The roofline and floor fractions above ``FRACTION_LIMIT``, and a
    violated floor check: each a fault of the floor or of the timing."""
    bad = [f"{k}={out[k]}" for k in ("fraction_of_roofline", "fraction_of_roofline_probed",
                                     "fraction_of_achievable", "fraction_of_achievable_probed",
                                     "fraction_of_achievable_busy",
                                     "fraction_of_achievable_probed_busy")
           if out.get(k) is not None and out[k] > FRACTION_LIMIT]
    if out.get("floor_check") == "VIOLATED":
        bad.append("floor_check=VIOLATED (the probed floor exceeds the step)")
    return bad


def main(argv=None) -> int:
    from .experiments.common import exact_f32
    from .ops import NormAdj
    from .ops.probe import probe_chip
    from .utils import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--scales", nargs="+", default=SCALES,
                    help="Zipf corpus sizes in documents, or 'protocol' for the 50k-document "
                         "synthetic-amazon graph; the last one headlines")
    ap.add_argument("--epochs", type=int, default=EPOCHS_MEASURED,
                    help="train steps in each timed block")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler traces of every variant under DIR, and each "
                         "variant's device busy ms and idle share in the output")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.profile and device.type != "cuda":
        ap.error("--profile reads the card's busy time: it needs --device cuda")
    exact_f32()
    log(f"device: {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'})")

    os.makedirs(PLAN_CACHE, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="bench-", dir=PLAN_CACHE)  # cold for this run
    try:
        results, graphs, scale_rows = {}, {}, []
        for scale in args.scales:
            g = protocol_graph(device) if scale == "protocol" else build_graph(int(scale), device)
            res = bench_scale(g, variants(cache), device, epochs=args.epochs,
                              profile_dir=args.profile, tag=str(scale))
            results[scale], graphs[scale] = res, g
            scale_rows.append({
                "scale": scale, "graph": {"n_nodes": g.n_nodes, "n_edges": g.n_edges},
                "step_ms": {k: round(v * 1e3, 4) for k, v in res["step_s"].items()},
                "step_ms_spread": {k: [round(t * 1e3, 4) for t in v]
                                   for k, v in res["spread"].items()},
                "build_s": {k: round(v, 3) for k, v in res["build_s"].items()},
                "hybrid_k": res["hybrid_k"],
                "floor_ms": {k: round(v / 1e6, 4) for k, v in res["floor_ns"].items()},
                "launches_per_step": res["launches_per_step"],
                **({"device_busy": res["busy"]} if args.profile else {}),
            })
        last = args.scales[-1]
        g, res = graphs[last], results[last]

        probe_kw = {} if device.type == "cuda" else dict(e=100_000, nk=4_096, reps=1, chain=(2, 4))
        probe = probe_chip(device=device, **probe_kw)
        log(f"probe: gather {probe.gather_ns:.4f} ns/row (copied out "
            f"{probe.gather_copy_ns:.4f}), stream {probe.stream_bps / 1e9:.0f} GB/s, "
            f"D-read {probe.hbm_bps / 1e9:.0f} GB/s, f32 {probe.mxu_f32_fps / 1e12:.1f} TF/s, "
            f"TF32 {probe.mxu_tf32_fps / 1e12:.1f}, bf16 {probe.mxu_bf16_fps / 1e12:.1f} "
            f"(slope fell back for {list(probe.fallbacks)})")

        # the plan cache: the floor variant's operator was built cold into
        # this run's cache; a fresh build of the same operator loads it warm
        plan_fields = {}
        frac_name = floor_path(res)
        if frac_name is not None:
            kw = dict(variants(cache))[frac_name]
            t0 = time.perf_counter()
            warm = NormAdj.from_graph(g, use_pallas=True, device=device, h_hint=N_HIDDEN,
                                      **{k: v for k, v in kw.items() if k != "masked_head"})
            warm_s = time.perf_counter() - t0
            if getattr(warm.plan, "k", None) != res["plans"][frac_name].k:
                raise RuntimeError("the warm plan's K differs from the cold build's")
            plan_fields = {"plan_cold_s": round(res["build_s"][frac_name], 3),
                           "plan_warm_s": round(warm_s, 3)}
            log(f"plan cache at E={g.n_edges}: cold {res['build_s'][frac_name]:.2f}s, "
                f"warm {warm_s:.2f}s")
            del warm
    finally:
        shutil.rmtree(cache, ignore_errors=True)

    out = headline(g, res, results[args.scales[0]], probe, device, plan_fields, scale_rows)
    bad = check_fractions(out)
    print(json.dumps(out), flush=True)
    if bad:
        log("FAILED: " + "; ".join(bad))
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
