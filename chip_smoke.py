#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytextgcn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py                      # the full check, ~4 min
    python3 chip_smoke.py --profile OUT_DIR    # also torch.profiler tables of the
                                               # CSR and hybrid train steps

Phases, each fatal (exit code 1, no result line) when it fails:

1. build: the two CUDA kernels (``csrc/spmm_csr.cu``, ``csrc/fused_dual.cu``,
   nvcc for sm_90a, their ptxas registers and spills), three timing builds
   of the CSR kernel (every row read from L1, no row reads, cache hints:
   ``CSR_TIMING_BUILDS``), four of the dual kernel (f32: one TF32
   pass, no split; split: one bf16 pass; split and bf16: float4 hot
   atomics) and the native host library (g++), side by side; print the
   card and its power limit as nvidia-smi gives them.
2. graph: the synthetic-amazon corpus (50k docs) through the port's flat
   experiment (``load_corpus`` -> ``Text2Graph``); print N and E.
3. check: the CSR kernel against its plain PyTorch version on the card, on
   this graph's forward and transpose plans at both widths the main path
   uses (hidden 100 and 43 classes), in f32 and bf16, the gradient through
   the autograd function, and a small graph with isolated nodes.
4. main path (CSR kernel): the flat experiment's ``run`` (``Trainer.fit`` with
   an eval every epoch, ``evaluate``, the results row) on the CSR kernel
   plan. The kernel's launch count must rise by exactly 4 per train step
   plus 2 per forward-only pass; losses must be finite and falling, and the
   model's logits must agree with the plain aggregation path.
5. hybrid plan: the dense-hot/sparse-cold decomposition of the same graph
   at K = 4096, f32 'split2' (D as a bf16 hi/lo pair); print K, the
   residual edge count, D's bytes and the build time.
6. dual kernel: its split, bf16 and f32 variants and the [H, K] hot layout
   against their plain versions, at both widths, with the forward operands
   (x, x_hot) and the backward ones (g_out, g_hot), plus a ragged shape
   with K < 128 and the gradient through the autograd function; every
   variant's out must repeat bit for bit (it is written without atomics),
   and the split and bf16 variants' prologue must give the planes of its
   plain version bit for bit.
7. hybrid SpMM: ``spmm`` on the hybrid plan against ``spmm_segment``,
   forward and gradient, at both widths.
8. hybrid paths: the flat experiment's ``run`` with ``--train-hybrid-k
   4096`` (the default f32 'split2' mode; the dual kernel's split variant
   and the CSR kernel on the residual must each launch exactly 4 times per
   train step plus 2 per forward-only pass; losses finite and falling;
   logits agree with the plain path), then short runs with
   ``--train-hybrid-fused on`` in f32 'highest' and in bf16 (the f32 and
   bf16 variants), and the dual product through ``fused_dual_t`` (the
   [H, K] layout, whose only JAX caller is a probe).
9. times: each kernel, its plain version, its library yardstick (used
   nowhere in the port: ``torch.sparse.mm`` for the CSR kernel, the two
   ``torch.mm`` of the dense pair for the dual kernel) and its bound per
   launch, the split and bf16 variants with their prologue; the CSR
   kernel's timing builds beside it in turns, at both widths on both
   plans, with H = 43 against x padded to 44 by hand; the split, bf16
   and f32 dual kernels without the hot side's reduction, and the split and
   bf16 ones with float4 atomics in place of their bulk reduction; the f32
   and split variants' timing builds beside them, in turns (what limits
   them);
   the hybrid SpMM per application; train steps on the CSR, hybrid and
   plain paths; peak memory; and the split kernel at K = 1024, 2048 and
   4096.
10. models and hierarchies, on the CSR kernel and phase 2's graph at full
   width, ``MODEL_EPOCHS`` epochs each: the flat experiment with EGCN
   (embedding 2000, hidden 100) and with the JK network (hidden 100), the
   per-level experiment (Cat1 -> Cat2), the per-label experiment (one GCN
   for each of the 6 Cat1 classes) writing its members with
   ``--save-model`` to a temporary directory, and ``--eval-only`` reading
   them back, which must give the same predictions; the per-level and
   per-label runs must each write their results row. On each path the
   kernel must launch exactly 4 times per train step plus 2 per
   forward-only pass of every level or member, each loss must be finite
   and fall (a member with one class has a loss of exactly 0), and the
   kernel must match its plain version at every width the path ran; each
   path's train step time and peak memory are printed. Composed per-label
   inference runs the members as one batched pass (2 launches).
11. the trainer's operator options, each through its entry point at full
   width: the flat experiment with ``--train-masked-head`` (launches by
   plan shape exact: 2 full and 2 restricted a train step, 2 full a
   forward-only pass; the first step's loss and gradients against the
   full-output step from the same parameters at dropout 0; the restricted
   forward [M, N] and transpose [N, M] plans against the plain version,
   empty rows exact zeros; its step beside the full-output step);
   the cost model's constants fitted from this run (the CSR kernel by
   width up to 600, the segment path, the dual kernels' K sweep, the
   restricted head's slab product) beside the ones in use; ``'auto'`` at
   H = 100 (every candidate modeled, K = 0, 1024, 2048, 4096 and the chosen
   one measured: the chosen K must time within 10% of the fastest) and the
   flat experiment with ``--train-hybrid-k auto``; the restricted chooser
   the same way at H = 43; the per-label experiment with ``--train-ep``
   (one launch of width 6 x 100 per application, counts exact), its
   members against six sequential ones from the same initialization at
   dropout 0 (rtol 2e-4, atol 2e-5), its step against the six sequential
   steps; the CSR kernel at H = 600 against its plain version; and the
   plan cache (cold build, warm load, the loaded plan equal bit for bit,
   the flat experiment's losses on a cold and on a warm cache equal).
12. the MLP baselines, the CSV loaders and the last trainer options: the
   MLP experiment (TF-IDF of the synthetic-amazon split, MLP [256, 128])
   flat, per-level and per-label, ``MODEL_EPOCHS`` epochs a model, its CSR
   launches exact (by plan shape for flat: the train plan S, its transpose
   for the first layer's gradient, the validation and test plans; losses
   falling), each of those plans against the plain version with its times
   and bound, the gradient through the autograd function, the MLP step's
   time; the flat experiment on a CSV dataset written here (``--dataset
   csv``); one ``--train-debug-checks`` epoch (on the kernel's path)
   and a NaN edge weight, which must raise; a flat ``--train-optimizer
   optax_amsgrad`` fit; the per-label experiment with ``--train-ep`` for
   EGCN and for JK members (launches by width exact, the members' summed
   loss falling), their members against sequential ones from the same
   initialization at dropout 0 (losses, logits, parameters), their steps
   against the sequential members' steps, and the batched LSTM against
   one cuDNN call a member.
13. device counting and mini-batching, on phase 2's corpus and graph: the
   corpus's tokens counted by ``word_word_edges_device`` on the card at two
   chunk budgets (2^24, 2^26; chunks, seconds, peak memory), each equal bit
   for bit to the native kernel's edges, weights and window count; the
   graph rebuilt by ``Text2Graph(backend='auto')`` with the native limit set
   below its triangle (device counting), equal to phase 2's bit for bit;
   the flat experiment with ``--train-batch-size 4096`` for one epoch (9
   batches; CSR launches exactly 4 a batch plus 2 for the final evaluate),
   its first batch's plans built on the card equal to the host's bit for
   bit, its batch-node logits against the full graph's from the run's
   initial parameters, the kernel at the subgraph's plans (H = 100 and 43)
   against its plain version with its times, and the seconds a batch of
   the batcher, the plans and the step; then a 3,000-doc corpus at batch
   128 for 5 epochs, whose loss must fall.

14. tooling and drivers: (a) the probe (``ops/probe.py``) on the card:
   gather ns a row (gathered and summed, and copied out), stream, D-read,
   f32, TF32 and bf16 rates, each within 1.05 of the H100's data-sheet
   peak, printed beside the cost model's constants, and the floor's price
   of a residual edge (``_GATHER_NS``) in use beside this run's, below the
   CSR kernel's edge; (b) the bench's variant loop
   (``pytextgcn_tpu_torch/bench.py``) on phase 2's graph: every variant
   runs, its kernel launches a step equal what its plans imply (the
   explicit-K variants: the split, f32 and bf16 dual kernels), losses
   finite, its floor check ok and every roofline and floor fraction within
   1.05, the floors held against the host's step and against the floor
   path's device busy time (torch.profiler); (c) the hyperopt driver, a 2-fold grid at
   3,000 documents, flat and per-label: no NaN row, CSR launches exact;
   (d) ``benchmark_graph`` with the native and device backends at 3,000
   documents and ``--plan-bench``: the same edges; (e) the protocol driver
   with ``--hybrid-k 4096`` in split2 and in bf16, 5 epochs each on one
   build of its 50k-doc graph: dual-kernel launches exact; (g) the host graph build and the
   CSR plan build with and without ``tune_allocator``
   (``PYTEXTGCN_NO_MALLOPT=1``), each in a process of its own
   (``--allocator-timing``). (f), compute-sanitizer over the kernels, is
   left out: the card's machine ships the tool, and it answers "Device not
   supported" for the card (ROADMAP.md).

It prints a ``{"kernels": [...]}`` line, the card line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))

HOT_K = 4096  # the hybrid's hot-set size on the main path
MODEL_EPOCHS = 5  # epochs of each phase-10 path (a level or member each)
K_SWEEP = (1024, 2048, 4096)

# Tolerances are relative to the sum of the terms' magnitudes (|A| @ |x|,
# spmm_cuda.spmm_csr_abs), which bounds what summing in another order moves
F32_RTOL, ATOL = 1e-5, 1e-6  # f32 sums in another order
BF16_RTOL = 2.0**-8  # x rounded to bf16 (relative error <= 2^-9) against f32 x
LOGIT_RTOL = 1e-4  # logits two sums deep, relative to the largest logit
# EGCN embedding entries whose SELU input comes this close to 0, SELU's
# kink, are left out of the batched ensemble's parameter check against
# sequential members (ep_against_sequential)
KINK_MARGIN = 1e-5
SPLIT2_RTOL = 3e-5  # the split2 class against f32 (tests/test_spmm_hybrid.py:73-79)
PEAK_SLACK = 1.05  # a probe reading above this share of its spec peak is a fault
BENCH_EPOCHS = 5  # steps in each of the bench's timed blocks, phase 14
HYPEROPT_EPOCHS = 10  # epochs of each fold in phase 14's grid


def spec_peak(key: str) -> float:
    """An H100 data-sheet peak in bytes or flops a second, from the port's
    one table of them (``train/profiling.py::H100_PEAK``): ``hbm_gbps``,
    ``f32_tflops``, ``tf32_tflops`` or ``bf16_tflops``."""
    from pytextgcn_tpu_torch.train.profiling import H100_PEAK

    return H100_PEAK[key] * (1e9 if key == "hbm_gbps" else 1e12)


_T0 = time.perf_counter()


def log(msg: str) -> None:
    if msg.startswith("[") and "/14]" in msg[:7]:  # a phase's header: when it began
        msg = f"{msg.split(']', 1)[0]} at {time.perf_counter() - _T0:.1f}s]{msg.split(']', 1)[1]}"
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if res.returncode != 0 or not res.stdout.strip():
        fail(f"nvidia-smi failed ({res.returncode}): {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Mean device time of ``fn`` per call, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


# timing builds of csrc/spmm_csr.cu (phase 9), never used for results:
# name -> (nvcc flags, what the build leaves out or changes)
CSR_TIMING_BUILDS = {
    "l1_resident": (["-DSPMM_L1_RESIDENT"],
                    "gather x[col & 511]: every row read hits L1, no L2 traffic for x"),
    "no_gather": (["-DSPMM_NO_GATHER"],
                  "no x loads: the (col, val) stream, its broadcast and the FMAs"),
    "cache_hints": (["-DSPMM_CACHE_HINTS"],
                    "(col, val) read and out written evict-first, x read L2 evict-last"),
}


def time_spmm_builds(kernel, builds: dict, plans: dict, widths, gen, reps: int = 30) -> list:
    """Per width and plan: ms per launch of ``kernel`` (key "kernel") and
    of each of ``builds`` in turns (each in order, then in reverse), and, at
    a width that is not a multiple of 4, the kernel on x padded to one by
    hand ("padded_to_4") and the pad copy ("pad_copy"). Each value is a
    list of times, one per turn."""
    import torch

    rows = []
    for h in widths:
        for pname, csr in plans.items():
            x = torch.randn(csr.n_cols, h, generator=gen, device=csr.device)
            cases = {"kernel": lambda: kernel(csr, x)}
            cases.update((name, (lambda b: lambda: b(csr, x))(b)) for name, b in builds.items())
            if h % 4:
                xp = torch.nn.functional.pad(x, (0, -h % 4))
                cases["padded_to_4"] = lambda: kernel(csr, xp)
                cases["pad_copy"] = lambda: xp[:, :h].copy_(x)
            row = {"h": h, "plan": pname, **{name: [] for name in cases}}
            for name in list(cases) + list(cases)[::-1]:
                row[name].append(time_ms(cases[name], reps))
            rows.append(row)
    return rows


def compare(name: str, got, want, scale, rtol: float, atol: float = ATOL) -> float:
    """Fails unless ``|got - want| <= atol + rtol * scale`` everywhere."""
    import torch

    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    if not torch.isfinite(got).all():
        fail(f"{name}: non-finite values")
    diff = (got.float() - want.float()).abs()
    err = float(diff.max()) if got.numel() else 0.0
    ok = bool((diff <= atol + rtol * scale).all())
    rel = float((diff / (atol + scale)).max()) if got.numel() else 0.0
    log(f"  check {name}: max_abs_err={err:.3e}, max err/scale={rel:.2e} "
        f"(rtol {rtol:g} of the scale, atol {atol:g}) {'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: kernel and plain version disagree")
    return err


def profile_step(out_dir: str, card: str, title: str, tag: str, step, step_ms: float) -> float:
    """torch.profiler over 5 calls of ``step``: writes its table and chrome
    trace under ``out_dir`` and returns the device's busy ms a step (the
    union of its kernel, memcpy and memset spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pytextgcn_tpu_torch.train.profiling import device_busy_us

    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) / 5 * 1e3
    table = prof.key_averages().table(sort_by="cuda_time_total", row_limit=25)
    trace = os.path.join(out_dir, f"trace_train_step_{tag}.json")
    prof.export_chrome_trace(trace)
    busy_ms = device_busy_us(trace) / 5 / 1e3
    # the profiler slows the host, so idle is read against the step time
    # measured just before without it
    summary = (f"device busy {busy_ms:.3f} ms a step (union of kernel, memcpy and memset "
               f"spans); host clock {step_ms:.3f} ms a step unprofiled ({host_ms:.3f} under "
               f"the profiler): device idle {1 - busy_ms / step_ms:.1%} of the unprofiled step")
    with open(os.path.join(out_dir, f"profile_train_step_{tag}.txt"), "w") as f:
        f.write(f"{card}\n5 train steps, {title}\n{summary}\n{table}\n")
    log(table)
    log(f"  {title}: {summary}")
    return busy_ms


def host_step_ms(step, reps: int = 20, warmup: int = 3) -> float:
    """Mean host-clock ms of ``step`` over ``reps`` calls, synchronized."""
    import torch

    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def spmm_work(csr, h: int, x_bytes: int):
    """Bytes the product must move (plan read once, x read once, out
    written once) and its FMA operations, for this plan's edges."""
    e = csr.n_edges
    n_bytes = 4 * (csr.n_rows + 1) + 8 * e + csr.n_cols * h * x_bytes + csr.n_rows * h * 4
    flops = 2 * e * h
    t_bytes = n_bytes / spec_peak("hbm_gbps") * 1e3
    t_ops = flops / spec_peak("f32_tflops") * 1e3
    return n_bytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def dual_work(variant: int, n: int, k: int, h: int):
    """Bytes the dual product must move (D, x and xh read once, out and hot
    written once) and its operations, for one launch on ``[n, k]`` D at
    width h. The split runs three bf16 products a side; the f32 variant
    three TF32 products a side (big·big + big·small + small·big: f32-class
    on the tensor cores, where one TF32 pass would lose ~2^-11), so its
    operations are three TF32 passes at the TF32 peak."""
    from pytextgcn_tpu_torch.ops import fused_dual as fd

    d_item, x_item = {fd.SPLIT: (4, 4), fd.BF16: (2, 2), fd.F32: (4, 4)}[variant]
    n_bytes = n * k * d_item + (n + k) * h * (x_item + 4)
    flops = (1 if variant == fd.BF16 else 3) * 2 * 2 * n * k * h
    peak = spec_peak("tf32_tflops") if variant == fd.F32 else spec_peak("bf16_tflops")
    t_bytes = n_bytes / spec_peak("hbm_gbps") * 1e3
    t_ops = flops / peak * 1e3
    return n_bytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def sparse_csr(csr):
    """The plan as a torch sparse CSR tensor, for the library yardstick
    (``torch.sparse.mm``), used nowhere in the port."""
    import torch

    return torch.sparse_csr_tensor(csr.row_ptr, csr.col.contiguous(), csr.val.contiguous(),
                                   size=(csr.n_rows, csr.n_cols), check_invariants=False)


def chunked(fn, csr, x, width: int = 128):
    """``fn(csr, x)`` (the plain version, or its magnitudes) over column
    blocks of x: the plain version's gather holds an ``[E, H]`` copy, 32 GB
    at H = 600 on the 50k-doc graph."""
    import torch

    return torch.cat([fn(csr, x[:, i:i + width].contiguous())
                      for i in range(0, x.shape[1], width)], dim=1)


def run_path(flat, cfg, g, n_classes, counters):
    """``flat.run`` with every launch count set to 0 just before it; returns
    the result, the seconds, and each counter's launches in the run."""
    import torch

    for reset in counters.values():
        reset[0]()
    with tempfile.TemporaryDirectory() as tmp:
        cfg.result_file = os.path.join(tmp, "results.csv")
        t0 = time.perf_counter()
        res = flat.run(cfg, g, n_classes)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        with open(cfg.result_file) as f:
            res["row"] = f.read().strip().splitlines()[-1]
    return res, secs, {name: read() for name, (_, read) in counters.items()}


def models_and_hierarchies(args, card, cfg, g, n_classes: int, hidden: int, plan, counters, gen,
                           dev):
    """Phase 10: the EGCN and JK flat paths, the per-level and per-label
    paths and the per-label ``--save-model`` / ``--eval-only`` round trip on
    ``g`` (phase 2's graph), each driven with the launch counts set to 0
    just before it. Returns (per-path summaries, the widths the paths ran,
    the kernel's errors against its plain version at those widths)."""
    import numpy as np
    import torch

    from pytextgcn_tpu_torch.config import check_ported, parse_config
    from pytextgcn_tpu_torch.experiments import common, flat, perlabel, perlevel
    from pytextgcn_tpu_torch.ops import spmm_cuda

    kernel, plain, mag = (spmm_cuda.spmm_csr_kernel, spmm_cuda.spmm_csr_reference,
                          spmm_cuda.spmm_csr_abs)
    n, e = g.n_nodes, g.n_edges
    log(f"[10/14] models and hierarchies on the CSR kernel ({MODEL_EPOCHS} epochs a "
        "level or member):")
    _, (cat1, cat2), _, _ = common.load_corpus(cfg, levels=["Cat1", "Cat2"])
    if not np.array_equal(cat2, np.asarray(g.y)[g.n_vocab:]):
        fail("the corpus's Cat2 labels differ from phase 2's graph")
    p10 = ["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
           "--model-n-hidden", str(hidden), "--model-dropout", "0.7", "--train-lr", "0.05",
           "--train-epochs", str(MODEL_EPOCHS), "--train-eval-every", "1",
           "--train-verbose", "0", "--train-use-pallas", "true"]

    def drive(fn, *fn_args, **fn_kw):
        """``fn`` with every launch count set to 0 just before it; returns its
        result, the seconds, the counts just after, and the peak memory
        above what was held before it (GB)."""
        torch.cuda.synchronize()
        mem0 = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        for reset, _ in counters.values():
            reset()
        t0 = time.perf_counter()
        out = fn(*fn_args, **fn_kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {name: read() for name, (_, read) in counters.items()}
        return out, secs, counts, (torch.cuda.max_memory_allocated() - mem0) / 1e9

    def passes(hist):
        """Launches a fit makes: 4 a train step, 2 an evaluation."""
        return 4 * len(hist) + 2 * sum("val_f1" in rec for rec in hist)

    def check_losses(label, hist, n_out):
        losses = [rec["loss"] for rec in hist]
        if len(losses) != MODEL_EPOCHS or not np.isfinite(losses).all():
            fail(f"{label}: {len(losses)} steps, losses {losses}")
        if n_out == 1:  # one class: the cross-entropy is exactly 0
            if any(losses):
                fail(f"{label}: a one-class member's losses {losses} are not 0")
        elif not losses[-1] < losses[0]:
            fail(f"{label}: the loss did not fall: {losses}")
        return f"{losses[0]:.4f} -> {losses[-1]:.4f}"

    y0 = torch.zeros(n, dtype=torch.int64, device=dev)  # a label every width takes
    mask_dev = torch.as_tensor(g.train_mask, device=dev)
    paths, widths_run = {}, set()

    def record(name, trainers, secs, counts, expected, peak_gb, summary, timed):
        """Checks the path's launch count, notes its widths, and times a
        train step of ``timed`` (one of its trainers; None: no timing)."""
        if counts["csr"] != expected or counts["dual"]:
            fail(f"{name}: launches {counts}, expected {expected} CSR launches")
        widths = sorted({layer.w.shape[1] for t in trainers for layer in t.model.layers})
        widths_run.update(widths)
        entry = {"seconds": secs, "launches": counts["csr"], "widths": widths,
                 "peak_memory_gb": peak_gb}
        timing = ""
        if timed is not None:
            step = lambda: timed._train_step(timed._adj, timed._feats, y0, mask_dev)
            entry["step_ms"] = host_step_ms(step, reps=10)
            timing = f"; train step {entry['step_ms']:.3f} ms (host clock"
            if args.profile:
                entry["device_busy_ms"] = profile_step(
                    args.profile, card, f"{name}, N={n} E={e}", name.replace(" ", "_"),
                    step, entry["step_ms"])
                timing += f", device busy {entry['device_busy_ms']:.3f}"
            timing += ")"
        paths[name] = entry
        log(f"  {name} in {secs:.1f}s: CSR launches {counts['csr']} (expected {expected}); "
            f"{summary}; widths {widths}{timing}; peak memory {peak_gb:.2f} GB above what "
            "was held before it")

    # EGCN at the protocols' lr 0.05 first climbs (Adam moves every embedding
    # weight by 0.05 a step, over 10x its init range) and is not back under
    # its first loss in 40 epochs; at 0.005 it falls from the first steps
    for model_name, extra in (("egcn", ["--train-lr", "0.005"]), ("jk", [])):
        mcfg = parse_config(p10 + ["--model-model", model_name] + extra)
        check_ported(mcfg)
        with tempfile.TemporaryDirectory() as tmp:
            mcfg.result_file = os.path.join(tmp, "results.csv")
            res, secs, counts, peak = drive(flat.run, mcfg, g, n_classes)
        model = res["trainer"].model
        if model_name == "egcn" and tuple(model.embed.w.shape) != (n, 2000):
            fail(f"egcn: embedding {tuple(model.embed.w.shape)}, expected ({n}, 2000)")
        loss = check_losses(model_name, res["history"], n_classes)
        record(f"{model_name} flat", [res["trainer"]], secs, counts,
               passes(res["history"]) + 2, peak,
               f"loss {loss}, test acc {res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}",
               res["trainer"])
        del res, model

    rows_dir = tempfile.TemporaryDirectory()
    rows_file = os.path.join(rows_dir.name, "results.csv")
    lcfg = parse_config(p10 + ["--result-file", rows_file])
    check_ported(lcfg)
    res, secs, counts, peak = drive(perlevel.run, lcfg, g, [cat1, cat2])
    losses = [check_losses(f"per-level level {i + 1}", h, w)
              for i, (h, w) in enumerate(zip(res["histories"], (6, n_classes)))]
    if tuple(res["trainers"][1]._feats.hierarchy.shape) != (g.n_docs, 6):
        fail("per-level: level 2 does not carry the Cat1 columns")
    # each level's fit, level 1's softmax on its own graph, the final evaluation
    record("gcn per-level", res["trainers"], secs, counts,
           sum(passes(h) for h in res["histories"]) + 2 + 2, peak,
           f"losses {losses}, test acc {res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}",
           res["trainers"][-1])  # level 2: the Cat2 head on the Cat1 columns
    del res

    with tempfile.TemporaryDirectory() as models_dir:
        pcfg = parse_config(p10 + ["--save-model", models_dir, "--result-file", rows_file])
        check_ported(pcfg)
        res, secs, counts, peak = drive(perlabel.run, pcfg, g, cat1, cat2)
        if len(res["trainers"]) != 6:
            fail(f"per-label: {len(res['trainers'])} members, expected 6")
        sizes = [len(res["mapping"][c]) for c in range(6)]
        losses = [check_losses(f"per-label member {c}", h, size)
                  for c, (h, size) in enumerate(zip(res["histories"], sizes))]
        # composed inference runs the six members as one batched pass: 2 launches
        record("gcn per-label", res["trainers"], secs, counts,
               sum(passes(h) for h in res["histories"]) + 2, peak,
               f"6 members of {sizes} classes, losses {losses}, test acc "
               f"{res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}",
               res["trainers"][int(np.argmax(sizes))])  # the member with the most classes
        back, secs, counts, peak = drive(perlabel.run, pcfg, g, cat1, cat2, eval_only=True)
        if not np.array_equal(back["predictions"], res["predictions"]):
            fail("per-label --eval-only: predictions differ from the trained ensemble's")
        record("gcn per-label --eval-only", back["trainers"], secs, counts, 2, peak,
               f"{len(os.listdir(models_dir))} files read back, the same predictions, test "
               f"acc {back['accuracy']:.4f}", None)
        del res, back
    with open(rows_file) as f:
        rows = [line.split(",")[:3] for line in f.read().splitlines()]
    rows_dir.cleanup()
    want = [["seed", "model", "hierarchy"]] + [["44", "GCN", h]
                                               for h in ("per-level", "per-label", "per-label")]
    if rows != want:
        fail(f"results rows {rows}, expected {want}")
    log(f"  results rows: {', '.join(r[2] for r in rows[1:])}")

    # the kernel against its plain version, and its time, at every width
    # these paths ran and at the dbpedia protocol's (9, 32, 70, 219), on
    # this graph
    errs, by_width = [], []
    for h in sorted(widths_run | {9, 32, 70, 219}):
        for pname, csr in (("fwd", plan.fwd), ("bwd", plan.bwd)):
            x = torch.randn(n, h, generator=gen, device=dev)
            errs.append(compare(f"f32 {pname} H={h}", kernel(csr, x), plain(csr, x),
                                mag(csr, x), F32_RTOL))
        x = torch.randn(n, h, generator=gen, device=dev)
        _, _, bound, bound_by = spmm_work(plan.fwd, h, 4)
        lib = sparse_csr(plan.fwd)
        row = {"h": h, "ms": time_ms(lambda: kernel(plan.fwd, x), 20),
               "plain_ms": time_ms(lambda: plain(plan.fwd, x), 3, warmup=1),
               "library_ms": time_ms(lambda: torch.sparse.mm(lib, x), 10),
               "bound_ms": bound, "bound_by": bound_by}
        by_width.append(row)
        log(f"  spmm_csr fwd H={h}: kernel {row['ms']:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by}, plain {row['plain_ms']:.4f} ms, torch.sparse.mm "
            f"{row['library_ms']:.4f} ms")
    torch.cuda.synchronize()
    return paths, sorted(widths_run), errs, by_width, (cat1, cat2)


def allclose(name: str, got, want, rtol: float, atol: float) -> float:
    """Fails unless ``|got - want| <= atol + rtol * |want|`` everywhere (the
    numpy band the trajectory tests use); returns the largest error."""
    import torch

    got, want = got.detach().float(), want.detach().float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}, or non-finite")
    diff = (got - want).abs()
    err = float(diff.max()) if got.numel() else 0.0
    ok = bool((diff <= atol + rtol * want.abs()).all())
    log(f"  check {name}: max_abs_err={err:.3e} (rtol {rtol:g}, atol {atol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name}: outside rtol {rtol:g}, atol {atol:g}")
    return err


def operator_options(args, card, g, n_classes: int, hidden: int, adj, counters, gen, dev,
                     cat1, cat2, csr_ms_by_width: dict):
    """Phase 11: the trainer's single-device operator options on ``g``, each
    driven through its entry point with the launch counts set to 0 just
    before it: the masked head (its first step against the full-output
    step, its restricted launches against the plain version), 'auto' K at
    H = ``hidden`` and the restricted chooser at H = ``n_classes`` (each
    candidate measured: the chosen K must time within 10% of the fastest),
    the batched per-label ensemble (one launch of width 6 * hidden per
    application; its members against six sequential ones), the plan cache
    (cold build, warm load, the same bits, the same losses), the CSR
    kernel at H = 600, and the cost model's constants fitted from this
    run. Returns (summary, kernel errors, kernel rows for the JSON line)."""
    import copy

    import numpy as np
    import torch

    from pytextgcn_tpu_torch.config import check_ported, make_model, parse_config
    from pytextgcn_tpu_torch.core.graph import gcn_normalize_np
    from pytextgcn_tpu_torch.experiments import flat, perlabel
    from pytextgcn_tpu_torch.hierarchy import perlabel as hpl
    from pytextgcn_tpu_torch.hierarchy import train_per_label
    from pytextgcn_tpu_torch.ops import NormAdj, hybrid
    from pytextgcn_tpu_torch.ops import fused_dual as fd
    from pytextgcn_tpu_torch.ops import spmm_cuda
    from pytextgcn_tpu_torch.ops.restricted import (RESTRICTED_CANDIDATES, _SLAB_BPS,
                                                    _SLAB_FLOPS, build_restricted_adj,
                                                    choose_restricted_k, spmm_restricted)
    from pytextgcn_tpu_torch.train.metrics import masked_cross_entropy
    from pytextgcn_tpu_torch.train.optim import resolve_optimizer

    kernel, plain, mag = (spmm_cuda.spmm_csr_kernel, spmm_cuda.spmm_csr_reference,
                          spmm_cuda.spmm_csr_abs)
    plan = adj.plan
    n, e = g.n_nodes, g.n_edges
    epochs = MODEL_EPOCHS
    base = ["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
            "--model-n-hidden", str(hidden), "--model-dropout", "0.7", "--train-lr", "0.05",
            "--train-epochs", str(epochs), "--train-eval-every", "1", "--train-verbose", "0"]
    out, errs, rows_json = {}, [], []
    y = torch.as_tensor(g.y, dtype=torch.int64, device=dev)
    train_mask = torch.as_tensor(g.train_mask, device=dev)
    log(f"[11/14] the trainer's operator options on the CSR kernel ({epochs} epochs a path):")

    # ---- the masked head through the flat experiment
    mcfg = parse_config(base + ["--train-masked-head", "true"])
    check_ported(mcfg)
    res, secs, counts = run_path(flat, mcfg, g, n_classes, counters)
    tm = res["trainer"]
    adj_out = tm._adj_out
    m = adj_out.m
    steps = len(res["history"])
    evals = sum("val_f1" in rec for rec in res["history"]) + 1
    want = {(n, n, hidden): 2 * steps + evals, (n, n, n_classes): evals,
            (m, n, n_classes): steps, (n, m, n_classes): steps}
    losses = [rec["loss"] for rec in res["history"]]
    log(f"  masked-head flat GCN in {secs:.1f}s: M={m} train rows, {adj_out.n_edges} edges "
        f"into them ({adj_out.n_edges / e:.1%} of E); CSR launches by (rows, cols, H) "
        f"{counts['csr_shapes']} (expected {want}); loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
        f"test acc {res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}")
    if counts["csr_shapes"] != want or counts["dual"]:
        fail(f"masked head: launches {counts}, expected {want}")
    if len(losses) != epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"masked head: losses {losses}")
    # the first step against the full-output step, same parameters, dropout 0
    model_m = make_model(mcfg.model, g.in_dim, n_classes,
                         generator=torch.Generator().manual_seed(7)).to(dev)
    model_m.dropout = 0.0
    model_f = copy.deepcopy(model_m)
    ones = torch.ones(m, dtype=torch.bool, device=dev)
    logits_m = model_m(tm._adj, tm._feats, train=True, adj_out=adj_out)
    loss_m = masked_cross_entropy(logits_m, y[adj_out.rows], ones)
    grads_m = torch.autograd.grad(loss_m, list(model_m.parameters()))
    logits_f = model_f(tm._adj, tm._feats, train=True)
    loss_f = masked_cross_entropy(logits_f, y, train_mask)
    grads_f = torch.autograd.grad(loss_f, list(model_f.parameters()))
    bitwise_rows = bool(torch.equal(logits_m, logits_f[adj_out.rows]))
    log(f"  first step at dropout 0: loss {loss_m.item():.7f} (masked head) vs "
        f"{loss_f.item():.7f} (full output); the train rows' logits "
        f"{'equal bit for bit' if bitwise_rows else 'differ in the last bits'}")
    allclose("masked-head loss vs full-output loss", loss_m, loss_f, 1e-5, 1e-6)
    for (name, _), gm, gf in zip(model_m.named_parameters(), grads_m, grads_f):
        allclose(f"masked-head gradient {name} vs full output", gm, gf, 1e-5, 1e-6)
    del logits_m, logits_f, grads_m, grads_f
    # the restricted launches against the plain version, and their times
    restricted_rows = []
    for pname, csr in (("restricted fwd", adj_out.res.fwd), ("restricted bwd", adj_out.res.bwd)):
        x = torch.randn(csr.n_cols, n_classes, generator=gen, device=dev)
        got = kernel(csr, x)
        errs.append(compare(f"{pname} [{csr.n_rows}, {csr.n_cols}] H={n_classes}", got,
                            plain(csr, x), mag(csr, x), F32_RTOL))
        empty = (csr.row_ptr[1:] == csr.row_ptr[:-1])
        if got[empty].any():
            fail(f"{pname}: rows with no edges are not exact zeros")
        lib = sparse_csr(csr)
        _, _, bound, bound_by = spmm_work(csr, n_classes, 4)
        row = {"plan": pname, "n_rows": csr.n_rows, "n_cols": csr.n_cols, "h": n_classes,
               "edges": csr.n_edges, "empty_rows": int(empty.sum()),
               "launches": want[(csr.n_rows, csr.n_cols, n_classes)],
               "ms": time_ms(lambda: kernel(csr, x), 50),
               "plain_ms": time_ms(lambda: plain(csr, x), 5, warmup=1),
               "library_ms": time_ms(lambda: torch.sparse.mm(lib, x), 20),
               "bound_ms": bound, "bound_by": bound_by}
        restricted_rows.append(row)
        log(f"  spmm_csr {pname} ({row['empty_rows']} of {csr.n_rows} rows empty): kernel "
            f"{row['ms']:.4f} ms, bound {bound:.4f} ms by {bound_by}, plain "
            f"{row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms")
    # step times: the masked head beside the full output, the same trainer
    y_rows, adj_full = y[adj_out.rows], tm._adj
    step_masked = lambda: tm._train_step(adj_full, tm._feats, y_rows, ones, adj_out)
    step_full = lambda: tm._train_step(adj_full, tm._feats, y, train_mask)
    masked_ms, full_ms = host_step_ms(step_masked), host_step_ms(step_full)
    masked = {"seconds": secs, "m": m, "restricted_edges": adj_out.n_edges,
              "launches": {str(k): v for k, v in counts["csr_shapes"].items()},
              "step_ms": masked_ms,
              "full_output_step_ms": full_ms, "first_step_rows_bitwise": bitwise_rows,
              "restricted": restricted_rows}
    timing = ""
    if args.profile:
        masked["device_busy_ms"] = profile_step(args.profile, card,
                                                f"masked head, N={n} E={e} M={m}",
                                                "masked_head", step_masked, masked_ms)
        masked["full_output_device_busy_ms"] = profile_step(
            args.profile, card, f"full output (beside the masked head), N={n} E={e}",
            "full_output", step_full, full_ms)
        timing = (f"; device busy {masked['device_busy_ms']:.3f} against "
                  f"{masked['full_output_device_busy_ms']:.3f} ms")
    log(f"  train step: masked head {masked_ms:.3f} ms, full output {full_ms:.3f} ms (host "
        f"clock, 20 steps){timing}")
    out["masked_head"] = masked
    del res, tm

    # ---- the cost model's constants, fitted from this run's timings
    src, dst = np.asarray(g.edge_src, np.int64), np.asarray(g.edge_dst, np.int64)
    norm_w, _ = gcn_normalize_np(src, dst, g.edge_w, n)
    x600 = torch.randn(n, 6 * hidden, generator=gen, device=dev)
    csr_ms_by_width = dict(csr_ms_by_width)
    csr_ms_by_width[6 * hidden] = time_ms(lambda: kernel(plan.fwd, x600), 20)
    seg_ms = {}
    for h in (1, 14, 43, 100, 219):
        xs = torch.randn(n, h, generator=gen, device=dev)
        seg_ms[h] = time_ms(lambda: hybrid.segment_sum(adj.src, adj.dst, adj.w, xs, n), 3,
                            warmup=1)
    del xs
    sweep = []
    for k in K_SWEEP:
        d32 = torch.randn(n, k, generator=gen, device=dev)
        pair, dbf = fd.split_bf16(d32), d32.bfloat16()
        for h in (hidden, n_classes):
            x = torch.randn(n, h, generator=gen, device=dev)
            xh = torch.randn(k, h, generator=gen, device=dev)
            xb, xhb = x.bfloat16(), xh.bfloat16()
            sweep.append({
                "k": k, "h": h,
                "split_ms": time_ms(lambda: fd.fused_dual_kernel(fd.SPLIT, *pair, x, xh), 10),
                "f32_ms": time_ms(lambda: fd.fused_dual_kernel(fd.F32, d32, None, x, xh), 10),
                "bf16_ms": time_ms(lambda: fd.fused_dual_kernel(fd.BF16, dbf, None, xb, xhb),
                                   10),
                "f32_mm_pair_ms": time_ms(lambda: (torch.mm(d32, xh), torch.mm(d32.t(), x)),
                                          10)})
        del d32, pair, dbf
    rows_t = torch.as_tensor(np.flatnonzero(g.train_mask), device=dev)
    slab = {}
    for h in (8, n_classes):
        dr = torch.randn(m, 4096, generator=gen, device=dev)
        xh = torch.randn(4096, h, generator=gen, device=dev)
        slab[h] = time_ms(lambda: torch.matmul(dr, xh), 20)
    del dr, xh
    at = lambda k, h, key: next(r[key] for r in sweep if r["k"] == k and r["h"] == h)
    kk = max(K_SWEEP)
    flops = lambda h: 4 * n * kk * h  # base flops of the dense pair
    fit = {
        "_HBM_BPS": n * kk * 4 / (at(kk, n_classes, "split_ms") * 1e-3),
        "_MXU_F32_HIGHEST": flops(hidden) / (at(kk, hidden, "f32_mm_pair_ms") * 1e-3),
        "_MXU_SPLIT_DENSE": flops(hidden) / (at(kk, hidden, "split_ms") * 1e-3),
        "_CSR_EDGE_NS": {h: ms * 1e6 / e for h, ms in sorted(csr_ms_by_width.items())},
        "_SEGMENT_EDGE_NS": {h: ms * 1e6 / e for h, ms in seg_ms.items()},
        "_SLAB_BPS": m * 4096 * 4 / (slab[8] * 1e-3),
        "_SLAB_FLOPS": 2 * m * 4096 * n_classes / (slab[n_classes] * 1e-3),
    }
    fit["_MXU_BF16_FACTOR"] = (flops(hidden) / (at(kk, hidden, "bf16_ms") * 1e-3)
                               / fit["_MXU_F32_HIGHEST"])
    in_use = {name: getattr(hybrid, name) for name in
              ("_HBM_BPS", "_MXU_F32_HIGHEST", "_MXU_SPLIT_DENSE", "_MXU_BF16_FACTOR",
               "_CSR_EDGE_NS", "_SEGMENT_EDGE_NS", "_HYBRID_NH_NS")}
    in_use.update(_SLAB_BPS=_SLAB_BPS, _SLAB_FLOPS=_SLAB_FLOPS)
    log(f"  cost model, fitted on {card}: {json.dumps(fit)}")
    log(f"  cost model, in ops/hybrid.py and ops/restricted.py "
        f"(COST_MODEL_VERSION {hybrid.COST_MODEL_VERSION}): {json.dumps(in_use)}")
    for r in sweep:
        log(f"  K sweep K={r['k']} H={r['h']}: split {r['split_ms']:.4f}, f32 "
            f"{r['f32_ms']:.4f}, bf16 {r['bf16_ms']:.4f}, two f32 torch.mm "
            f"{r['f32_mm_pair_ms']:.4f} ms")
    log(f"  segment path ms by H: {seg_ms}; restricted slab [{m}, 4096] @ [4096, H] ms by H: "
        f"{slab}")
    out["cost_model"] = {"fit": fit, "in_use": in_use, "k_sweep": sweep, "segment_ms": seg_ms,
                         "slab_ms": slab, "csr_ms_by_width": csr_ms_by_width}

    # ---- 'auto' K at H = hidden: every candidate modeled, four measured
    def rank_of(keys):
        deg = np.bincount(keys, minlength=n)
        r = np.empty(n, np.int64)
        r[np.argsort(-deg, kind="stable")] = np.arange(n)
        return r

    rank = rank_of(src)
    r_src, r_dst = rank[src], rank[dst]
    candidates = (0, 512, 1024, 2048, 4096, 8192, 12288, 16384)
    chosen = hybrid.choose_hot_k(src, n, h=hidden, itemsize=4, dst=dst, d_reads=1,
                                 dense_split=True)
    modeled = {0: e * hybrid.csr_edge_ns(hidden) / 1e6}
    for k in candidates[1:]:
        resid = int(np.sum((r_src >= k) & (r_dst >= k)))
        modeled[k] = hybrid._predict_cost_ns(n, e, resid, k, hidden, 4, d_reads=1,
                                             dense_split=True) / 1e6
    measured = {}
    x = torch.randn(n, hidden, generator=gen, device=dev)
    for k in sorted({0, 1024, 2048, 4096, chosen}):
        if k == 0:
            measured[0] = time_ms(lambda: spmm_cuda.spmm_plan(plan, x), 20)
            continue
        hp = hybrid.build_hybrid_plan(src, dst, norm_w, n, hot_k=k, device=dev,
                                      validate="fast", h_hint=hidden)
        measured[k] = time_ms(lambda: hybrid.spmm_hybrid(hp, x), 10)
        del hp
    fastest = min(measured, key=measured.get)
    # the hybrid's fixed passes over [N, H]: measured less modeled without them
    fixed_ms = hybrid._HYBRID_NH_NS * n * hidden / 1e6
    fit["_HYBRID_NH_NS"] = float(np.mean([measured[k] - modeled[k] + fixed_ms
                                          for k in measured if k])) * 1e6 / (n * hidden)
    log(f"  cost model, fitted: _HYBRID_NH_NS {fit['_HYBRID_NH_NS']:.5f} ns (in use "
        f"{hybrid._HYBRID_NH_NS})")
    log(f"  'auto' at H={hidden}: modeled ms {({k: round(v, 4) for k, v in modeled.items()})}; "
        f"chosen K={chosen}; measured ms per application "
        f"{({k: round(v, 4) for k, v in measured.items()})}; fastest K={fastest}")
    # the two choosers' checks fail at the end of the phase, so that one
    # run gives every measurement a recalibration needs
    late = []
    if measured[chosen] > 1.10 * measured[fastest]:
        late.append(f"'auto' chose K={chosen} ({measured[chosen]:.4f} ms), more than 10% over "
                    f"the fastest candidate K={fastest} ({measured[fastest]:.4f} ms)")
    acfg = parse_config(base + ["--train-hybrid-k", "auto", "--train-use-pallas", "true"])
    check_ported(acfg)
    ares, asecs, acounts = run_path(flat, acfg, g, n_classes, counters)
    a_steps = len(ares["history"])
    a_expected = 4 * a_steps + 2 * (sum("val_f1" in r for r in ares["history"]) + 1)
    a_plan = ares["trainer"]._adj.plan
    want_dual = {} if chosen == 0 else {"split": a_expected}
    log(f"  flat --train-hybrid-k auto in {asecs:.1f}s: plan {type(a_plan).__name__}"
        f"{'' if chosen == 0 else f' K={a_plan.k}'}; CSR launches {acounts['csr']}, dual "
        f"{acounts['dual']} (expected {a_expected} and {want_dual})")
    if acounts["csr"] != a_expected or acounts["dual"] != want_dual or (
            chosen == 0) != isinstance(a_plan, spmm_cuda.SpmmPlan):
        fail(f"'auto' path: {acounts}, plan {type(a_plan).__name__}")
    out["auto"] = {"h": hidden, "modeled_ms": modeled, "chosen": chosen,
                   "measured_ms": measured, "fastest": fastest, "seconds": asecs,
                   "launches": acounts["csr"]}
    del ares

    # ---- the restricted chooser at H = n_classes
    rows = np.flatnonzero(g.train_mask)
    local = np.full(n, -1, np.int64)
    local[rows] = np.arange(m)
    rsrc = src[local[dst] >= 0]
    rchosen = choose_restricted_k(rsrc, n, m, h=n_classes)
    rrank = rank_of(rsrc)[rsrc]
    per_edge = min(hybrid.csr_edge_ns(n_classes), hybrid.segment_edge_ns(n_classes))
    rmodeled = {0: len(rsrc) * per_edge / 1e6}
    for k in RESTRICTED_CANDIDATES:
        dense = max(m * k * 4 / _SLAB_BPS, 2 * m * k * n_classes / _SLAB_FLOPS) * 1e9
        rmodeled[k] = (dense + int(np.sum(rrank >= k)) * per_edge) / 1e6
    rmeasured = {}
    x = torch.randn(n, n_classes, generator=gen, device=dev)
    for k in (0,) + RESTRICTED_CANDIDATES:
        ra = build_restricted_adj(g, rows, use_pallas=True, hot_k=k or None,
                                  h_hint=n_classes, device=dev)
        rmeasured[k] = time_ms(lambda: spmm_restricted(ra, x), 20)
        del ra
    rfastest = min(rmeasured, key=rmeasured.get)
    log(f"  restricted chooser at H={n_classes}: modeled ms "
        f"{({k: round(v, 4) for k, v in rmodeled.items()})}; chosen K={rchosen}; measured ms "
        f"per application {({k: round(v, 4) for k, v in rmeasured.items()})}; fastest "
        f"K={rfastest}")
    if rmeasured[rchosen] > 1.10 * rmeasured[rfastest]:
        late.append(f"the restricted chooser chose K={rchosen} ({rmeasured[rchosen]:.4f} ms), "
                    f"more than 10% over the fastest K={rfastest} "
                    f"({rmeasured[rfastest]:.4f} ms)")
    out["restricted_auto"] = {"h": n_classes, "modeled_ms": rmodeled, "chosen": rchosen,
                              "measured_ms": rmeasured, "fastest": rfastest}

    # ---- the batched per-label ensemble through the per-label experiment
    width = 6 * hidden
    for csr_name, csr in (("fwd", plan.fwd), ("bwd", plan.bwd)):
        errs.append(compare(f"f32 {csr_name} H={width}", kernel(csr, x600),
                            chunked(plain, csr, x600), chunked(mag, csr, x600), F32_RTOL))
    with tempfile.TemporaryDirectory() as tmp:
        ecfg = parse_config(base + ["--train-ep", "true", "--result-file",
                                    os.path.join(tmp, "rows.csv")])
        check_ported(ecfg)
        for reset, _ in counters.values():
            reset()
        t0 = time.perf_counter()
        eres = perlabel.run(ecfg, g, cat1, cat2)
        torch.cuda.synchronize()
        esecs = time.perf_counter() - t0
        ecounts = {name: read() for name, (_, read) in counters.items()}
    sizes = [len(eres["mapping"][c]) for c in range(len(eres["trainers"]))]
    c_max = max(sizes)
    e_steps = len(eres["histories"][0])
    want = {(n, n, width): 2 * e_steps + 1, (n, n, 6 * c_max): 2 * e_steps + 1}
    log(f"  per-label --train-ep in {esecs:.1f}s: 6 members of {sizes} classes; CSR launches "
        f"by (rows, cols, H) {ecounts['csr_shapes']} (expected {want}: one launch of width "
        f"6 x {hidden} per application); test acc {eres['accuracy']:.4f}, macro-F1 "
        f"{eres['f1_macro']:.4f}")
    if len(sizes) != 6 or ecounts["csr_shapes"] != want or ecounts["dual"]:
        fail(f"per-label --train-ep: launches {ecounts}, expected {want}")
    for c, h in enumerate(eres["histories"]):
        losses = [r["loss"] for r in h]
        if len(losses) != epochs or not np.isfinite(losses).all() or (
                sizes[c] > 1 and not losses[-1] < losses[0]) or (sizes[c] == 1 and any(losses)):
            fail(f"per-label --train-ep member {c}: losses {losses}")
    del eres
    # the stacked members against six sequential ones from the same
    # initialization, dropout 0
    zcfg = parse_config(base + ["--model-dropout", "0"])
    factory = lambda: (lambda i, o, gen_=torch.Generator().manual_seed(44):
                       make_model(zcfg.model, i, o, generator=gen_))
    kw = dict(epochs=epochs, seed=44, trainer_kwargs={"device": dev})
    ep_run = train_per_label(g, cat2, cat1, factory(), ep=True, **kw)
    seq_run = train_per_label(g, cat2, cat1, factory(), **kw)
    ep_err = 0.0
    for c, (te, ts) in enumerate(zip(ep_run["trainers"], seq_run["trainers"])):
        for (name, pe), ps in zip(te.model.named_parameters(), ts.model.parameters()):
            ep_err = max(ep_err, allclose(f"EP member {c} {name} vs sequential", pe, ps,
                                          2e-4, 2e-5))
    # step times: one batched step against the six sequential members' steps
    models = [t.model for t in seq_run["trainers"]]
    params = hpl._stack_members(models, sizes, dev)
    opt = resolve_optimizer("adam", params, 0.05)
    members = hpl._member_label_arrays(g, cat2, cat1, 6)
    ym = torch.as_tensor(np.stack([yn for _, yn, _ in members], 1), dtype=torch.int64,
                         device=dev)
    mm = torch.as_tensor(np.stack([np.asarray(g.train_mask) & nm for _, _, nm in members], 1),
                         device=dev).float()
    gens = [torch.Generator(device=dev).manual_seed(44) for _ in models]
    tadj, tfeats = seq_run["trainers"][0]._adj, seq_run["trainers"][0]._feats
    ep_step = lambda: hpl.ep_train_step(params, opt, models[0], tadj, tfeats, ym, mm, gens)
    ep_ms = host_step_ms(ep_step)
    seq_ms = [host_step_ms(lambda t=t, yn=yn, nm=nm: t._train_step(
        tadj, tfeats, torch.as_tensor(yn, dtype=torch.int64, device=dev),
        torch.as_tensor(np.asarray(g.train_mask) & nm, device=dev)), reps=10)
        for t, (_, yn, nm) in zip(seq_run["trainers"], members)]
    ep = {"seconds": esecs, "sizes": sizes,
          "launches": {str(k): v for k, v in ecounts["csr_shapes"].items()},
          "step_ms": ep_ms, "sequential_step_ms": seq_ms, "max_abs_err_vs_sequential": ep_err}
    timing = ""
    if args.profile:
        ep["device_busy_ms"] = profile_step(args.profile, card, f"per-label EP step, N={n}",
                                            "perlabel_ep", ep_step, ep_ms)
        timing = f", device busy {ep['device_busy_ms']:.3f} ms"
    log(f"  EP train step {ep_ms:.3f} ms{timing} against {sum(seq_ms):.3f} ms for the six "
        f"sequential members' steps ({[round(v, 3) for v in seq_ms]}; host clock)")
    out["ep"] = ep
    del ep_run, seq_run, params, opt
    lib = sparse_csr(plan.fwd)
    _, _, bound, bound_by = spmm_work(plan.fwd, width, 4)
    h600 = {"h": width, "ms": csr_ms_by_width[width],
            "plain_ms": time_ms(lambda: chunked(plain, plan.fwd, x600), 1, warmup=1),
            "library_ms": time_ms(lambda: torch.sparse.mm(lib, x600), 5),
            "bound_ms": bound, "bound_by": bound_by,
            "launches": 2 * e_steps + 1}
    log(f"  spmm_csr fwd H={width}: kernel {h600['ms']:.4f} ms, bound {bound:.4f} ms by "
        f"{bound_by}, plain {h600['plain_ms']:.4f} ms, torch.sparse.mm "
        f"{h600['library_ms']:.4f} ms")
    del x600

    # ---- the plan cache: cold build, warm load, the same bits and losses
    with tempfile.TemporaryDirectory() as cache:
        times = []
        plans = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plans.append(NormAdj.from_graph(g, use_pallas=True, device=dev,
                                            plan_cache=cache).plan)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        same = all(torch.equal(getattr(a, f), getattr(b, f))
                   for a, b in ((plans[0].fwd, plans[1].fwd), (plans[0].bwd, plans[1].bwd))
                   for f in ("row_ptr", "pairs", "seg_ptr", "seg_row", "seg_slot",
                             "split_row", "split_ptr"))
        if not same:
            fail("plan cache: the loaded plan differs from the built one")
        del plans
        hists = []
        with tempfile.TemporaryDirectory() as cache2:
            pcfg = parse_config(base + ["--train-plan-cache", cache2])
            check_ported(pcfg)
            for _ in range(2):
                r, _, _ = run_path(flat, pcfg, g, n_classes, counters)
                hists.append([rec["loss"] for rec in r["history"]])
                del r
    log(f"  plan cache: cold build {times[0]:.2f} s, warm load {times[1]:.2f} s; loaded plan "
        f"equal to the built one bit for bit; the flat run on a cold and on a warm cache: "
        f"losses {'equal' if hists[0] == hists[1] else 'DIFFER'} ({hists[0]})")
    if hists[0] != hists[1]:
        fail(f"plan cache: the warm run's losses {hists[1]} differ from the cold run's")
    out["plan_cache"] = {"cold_s": times[0], "warm_s": times[1], "bitwise": same,
                         "losses": hists[0]}
    torch.cuda.synchronize()
    if late:
        fail("; ".join(late))
    return out, errs, {"restricted": restricted_rows, "h600": h600}


def ep_against_sequential(name: str, g, cat1, cat2, zcfg, epochs: int, dev):
    """The batched per-label ensemble of ``zcfg``'s model (dropout 0) held
    against its members trained one after another from the same
    initialization: the losses, each member's logits on the graph
    (LOGIT_RTOL of the largest) and every parameter within 2e-4 of the
    parameter's largest magnitude. Two exceptions, both where the function
    has a kink or a flat direction that rounding decides: the JK
    attention's bias, whose gradient is analytically zero (the softmax over
    the layers does not see a shift), so Adam's normalized steps move it
    on rounding alone; and the EGCN embedding's entries whose SELU input
    ``w + b`` came within KINK_MARGIN of 0 in the sequential run, where
    SELU's derivative jumps from lambda * alpha to lambda (1.673x): when
    the two runs' last bits put such an entry on opposite sides, their
    gradients there differ by that factor and Adam carries it into
    different steps. Returns (the largest error over the entries held, the
    sequential run as ``train_per_label`` returns it, the entries left out
    by parameter name)."""
    import numpy as np
    import torch

    from pytextgcn_tpu_torch.config import make_model
    from pytextgcn_tpu_torch.hierarchy import perlabel as hpl
    from pytextgcn_tpu_torch.hierarchy import train_per_label
    from pytextgcn_tpu_torch.train.trainer import Trainer

    lr = zcfg.train.lr
    factory = lambda: (lambda i, o, gen_=torch.Generator().manual_seed(44):
                       make_model(zcfg.model, i, o, generator=gen_))
    ep_run = train_per_label(g, cat2, cat1, factory(), ep=True, epochs=epochs, seed=44, lr=lr,
                             trainer_kwargs={"device": dev})
    # the sequential path of train_per_label, step by step, to follow the
    # EGCN embedding's SELU inputs
    members = hpl._member_label_arrays(g, cat2, cat1, int(np.max(cat1)) + 1)
    make = factory()
    trainers = [Trainer(make(g.in_dim, len(classes)), lr=lr, seed=44, optimizer="adam",
                        device=dev) for classes, _, _ in members]
    adj, feats = trainers[0].prepare(g)
    for t in trainers[1:]:
        t._adj, t._adj_key, t._feats = trainers[0]._adj, trainers[0]._adj_key, feats
    problems, histories, excluded, held_err = [], [], {}, 0.0
    for c, (t, te, (_, yn, nm)) in enumerate(zip(trainers, ep_run["trainers"], members)):
        y = torch.as_tensor(yn, dtype=torch.int64, device=dev)
        mask = torch.as_tensor(np.asarray(g.train_mask) & nm, device=dev)
        embed = getattr(t.model, "embed", None)
        near_kink = None if embed is None else torch.zeros_like(embed.w, dtype=torch.bool)
        hist = []
        for _ in range(epochs + 1):
            if embed is not None:
                near_kink |= (embed.w + embed.b).detach().abs() < KINK_MARGIN
            if len(hist) < epochs:
                hist.append({"loss": float(t._train_step(adj, feats, y, mask))})
        histories.append(hist)
        allclose(f"{name} EP member {c} losses vs sequential",
                 torch.tensor([r["loss"] for r in ep_run["histories"][c]]),
                 torch.tensor([r["loss"] for r in hist]), 2e-4, 2e-5)
        with torch.no_grad():
            le, ls = te.predict_logits(g), t.predict_logits(g)
        allclose(f"{name} EP member {c} logits vs sequential", le, ls, 0.0,
                 LOGIT_RTOL * float(ls.abs().max()))
        for (pn, ps), pe in zip(t.model.named_parameters(), te.model.parameters()):
            atol = 2e-4 * float(ps.detach().abs().max())
            err = (pe.detach() - ps.detach()).abs()
            out_mask = (torch.ones_like(err, dtype=torch.bool) if pn == "att.b" else
                        near_kink if pn == "embed.w" else torch.zeros_like(err, dtype=torch.bool))
            n_out = int(out_mask.sum())
            held = float(err[~out_mask].max()) if n_out < err.numel() else 0.0
            apart = float(err[out_mask].max()) if n_out else 0.0
            held_err = max(held_err, held)
            excluded[pn] = excluded.get(pn, 0) + n_out
            ok = held <= atol
            why = ("a zero gradient" if pn == "att.b" else
                   f"SELU input within {KINK_MARGIN:g} of its kink")
            left = f"; {n_out} left out ({why}) reach {apart:.3e}" if n_out else ""
            log(f"  check {name} EP member {c} {pn} vs sequential: max_abs_err={held:.3e} "
                f"(atol {atol:.3e}) over {err.numel() - n_out} of {err.numel()} "
                f"entries{left} {'ok' if ok else 'MISMATCH'}")
            if not ok:
                problems.append(f"{name} EP member {c} {pn}: {held:.3e} over atol {atol:.3e}")
        del near_kink
    if problems:
        fail("; ".join(problems))
    return held_err, {"trainers": trainers, "histories": histories}, excluded


def mlp_and_last_options(args, card, g, n_classes: int, hidden: int, counters, gen, dev,
                         cat1, cat2):
    """Phase 12: the TF-IDF + MLP baselines on the CSR kernel at the
    synthetic-amazon scale (the MLP experiment's flat run with exact launch
    counts by plan shape, every plan's launch against the plain version and
    its times, the step's time; its per-level and per-label runs), a CSV
    dataset written here through ``--dataset csv``, one ``--train-debug-checks``
    epoch (clean, then a NaN edge weight, which must raise), an
    ``--train-optimizer optax_amsgrad`` fit, and the batched per-label
    ensemble of EGCN and of JK members through the per-label experiment and
    against sequential members (its batched LSTM timed against the members'
    cuDNN calls). Returns (summary, kernel errors, MLP plan rows)."""
    import copy
    import dataclasses

    import numpy as np
    import torch

    from pytextgcn_tpu_torch.baselines import mlp_pipeline
    from pytextgcn_tpu_torch.config import check_ported, parse_config
    from pytextgcn_tpu_torch.data.synthetic import protocol_corpus
    from pytextgcn_tpu_torch.experiments import flat, perlabel
    from pytextgcn_tpu_torch.experiments import mlp as mlp_driver
    from pytextgcn_tpu_torch.hierarchy import perlabel as hpl
    from pytextgcn_tpu_torch.models import MLP, SparseMatrix
    from pytextgcn_tpu_torch.models.layers import stacked_bilstm
    from pytextgcn_tpu_torch.ops import spmm_cuda
    from pytextgcn_tpu_torch.train.optim import resolve_optimizer
    from pytextgcn_tpu_torch.train.trainer import dropout_seed

    kernel, plain, mag = (spmm_cuda.spmm_csr_kernel, spmm_cuda.spmm_csr_reference,
                          spmm_cuda.spmm_csr_abs)
    epochs = MODEL_EPOCHS
    n, e = g.n_nodes, g.n_edges
    out, errs = {}, []
    log(f"[12/14] the MLP baselines, the CSV loaders and the last trainer options "
        f"({epochs} epochs a path):")

    # ---- the MLP experiment at the synthetic-amazon scale
    mcfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
                         "--train-epochs", str(epochs), "--train-verbose", "0"])
    check_ported(mcfg, graph=False)
    t0 = time.perf_counter()
    splits, n_levels = mlp_driver.build_splits(mcfg, mlp_driver.default_levels(mcfg.dataset))
    splits_s = time.perf_counter() - t0
    kw = mlp_driver.train_kwargs(mcfg, set())
    b, v = splits.x_train.shape
    b_va, b_te = splits.x_val.shape[0], splits.x_test.shape[0]
    h1 = kw["hidden"][0]
    log(f"  TF-IDF splits in {splits_s:.1f}s: train [{b}, {v}] ({splits.x_train.nnz} nonzeros), "
        f"validation [{b_va}, {v}], test [{b_te}, {v}]; MLP {kw['hidden']}, lr {kw['lr']}, "
        f"dropout {kw['dropout']}")
    runs = {}
    for hierarchy in mlp_driver.HIERARCHIES:
        for reset, _ in counters.values():
            reset()
        t0 = time.perf_counter()
        res = mlp_driver.run(mcfg, splits, n_levels, hierarchy, kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        counts = {name: read() for name, (_, read) in counters.items()}
        runs[hierarchy] = (res, secs, counts)
    res, secs, counts = runs["flat"]
    # per level model: epochs x (train S, its transpose, validation) + 1 test
    want = {(b, v, h1): n_levels * epochs, (v, b, h1): n_levels * epochs,
            (b_va, v, h1): n_levels * epochs, (b_te, v, h1): n_levels}
    losses = [[l for l, _ in r["history"]] for r in res]
    log(f"  MLP flat (both levels) in {secs:.1f}s: CSR launches by (rows, cols, H) "
        f"{counts['csr_shapes']} (expected {want}); losses {losses}; test acc "
        f"{[round(r['accuracy'], 4) for r in res]}, macro-F1 "
        f"{[round(r['f1_macro'], 4) for r in res]}")
    if counts["csr_shapes"] != want or counts["dual"]:
        fail(f"MLP flat: launches {counts}, expected {want}")
    for ls in losses:
        if len(ls) != epochs or not np.isfinite(ls).all() or not ls[-1] < ls[0]:
            fail(f"MLP flat: losses {ls}")
    for hierarchy in ("per-level", "per-label"):
        hres, hsecs, hcounts = runs[hierarchy]
        n_models = 2 if hierarchy == "per-level" else 1 + len(np.unique(splits.y_train[0]))
        routed = 1 if hierarchy == "per-level" else len(np.unique(hres[0]["pred"]))
        hwant = 3 * epochs * n_models + 1 + routed
        log(f"  MLP {hierarchy} in {hsecs:.1f}s: {n_models} models, CSR launches "
            f"{hcounts['csr']} (expected {hwant}); test acc "
            f"{[round(r['accuracy'], 4) for r in hres]}, macro-F1 "
            f"{[round(r['f1_macro'], 4) for r in hres]}")
        if hcounts["csr"] != hwant or hcounts["dual"]:
            fail(f"MLP {hierarchy}: launches {hcounts}, expected {hwant}")
        if not all(0.0 <= r["accuracy"] <= 1.0 and np.isfinite(r["f1_macro"]) for r in hres):
            fail(f"MLP {hierarchy}: metrics {[(r['accuracy'], r['f1_macro']) for r in hres]}")
    out["mlp"] = {"splits_s": splits_s, "train_shape": [b, v], "nnz": splits.x_train.nnz,
                  "flat": {"seconds": secs, "launches": {str(k): c for k, c in
                                                         counts["csr_shapes"].items()},
                           "losses": losses},
                  **{h: {"seconds": runs[h][1], "launches": runs[h][2]["csr"]}
                     for h in ("per-level", "per-label")}}
    del runs, res

    # every plan of the MLP path against the plain version, and its times
    plan_rows = []
    for name, x_csr in (("train", splits.x_train), ("validation", splits.x_val),
                        ("test", splits.x_test)):
        xs = SparseMatrix.from_scipy(x_csr, use_pallas=True, device=dev)
        plans = (("fwd", xs.plan.fwd), ("bwd", xs.plan.bwd)) if name == "train" else (
            ("fwd", xs.plan.fwd),)
        for pname, csr in plans:
            x = torch.randn(csr.n_cols, h1, generator=gen, device=dev)
            got = kernel(csr, x)
            err = compare(f"MLP {name} {pname} [{csr.n_rows}, {csr.n_cols}] H={h1}", got,
                          plain(csr, x), mag(csr, x), F32_RTOL)
            errs.append(err)
            empty = csr.row_ptr[1:] == csr.row_ptr[:-1]
            if got[empty].any():
                fail(f"MLP {name} {pname}: rows with no entries are not exact zeros")
            lib = sparse_csr(csr)
            _, _, bound, bound_by = spmm_work(csr, h1, 4)
            row = {"plan": f"{name} {pname}", "n_rows": csr.n_rows, "n_cols": csr.n_cols,
                   "h": h1, "nnz": csr.n_edges, "empty_rows": int(empty.sum()),
                   "launches": want[(csr.n_rows, csr.n_cols, h1)], "max_abs_err": err,
                   "ms": time_ms(lambda: kernel(csr, x), 50),
                   "plain_ms": time_ms(lambda: plain(csr, x), 5, warmup=1),
                   "library_ms": time_ms(lambda: torch.sparse.mm(lib, x), 20),
                   "bound_ms": bound, "bound_by": bound_by}
            plan_rows.append(row)
            log(f"  spmm_csr MLP {row['plan']} ({row['empty_rows']} of {csr.n_rows} rows "
                f"empty): kernel {row['ms']:.4f} ms, bound {bound:.4f} ms by {bound_by}, plain "
                f"{row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms")
    # the gradient through the autograd function is the transpose launch
    xs = SparseMatrix.from_scipy(splits.x_train, use_pallas=True, device=dev)
    w = torch.randn(v, h1, generator=gen, device=dev, requires_grad=True)
    ct = torch.randn(b, h1, generator=gen, device=dev)
    (xs.matmul(w) * ct).sum().backward()
    errs.append(compare(f"MLP dW = S^T g [{v}, {h1}]", w.grad, plain(xs.plan.bwd, ct),
                        mag(xs.plan.bwd, ct), F32_RTOL))
    # the train step: forward, CE, backward, Adam at the full width
    model = MLP(v, int(splits.y_train[1].max()) + 1, list(kw["hidden"]), dropout=kw["dropout"],
                generator=torch.Generator().manual_seed(0)).to(dev)
    opt = resolve_optimizer("adam", model.parameters(), kw["lr"])
    y = torch.as_tensor(np.asarray(splits.y_train[1], np.int64), device=dev)
    mgen = torch.Generator(device=dev).manual_seed(dropout_seed(0))
    step = lambda: mlp_pipeline.mlp_train_step(model, opt, xs, y, mgen)
    step_ms = host_step_ms(step)
    out["mlp"]["step_ms"] = step_ms
    timing = ""
    if args.profile:
        out["mlp"]["device_busy_ms"] = profile_step(args.profile, card,
                                                    f"MLP step, S [{b}, {v}], H={h1}", "mlp",
                                                    step, step_ms)
        timing = f", device busy {out['mlp']['device_busy_ms']:.3f} ms"
    log(f"  MLP train step {step_ms:.3f} ms (host clock, 20 steps){timing}")
    del xs, w, ct, model, opt, splits

    # ---- a CSV dataset written here, through --dataset csv
    docs, levels, n_train, _ = protocol_corpus("amazon", n_docs=3000)
    with tempfile.TemporaryDirectory() as tmp:
        import csv as csv_mod

        for name, lo, hi in (("train.csv", 0, n_train), ("test.csv", n_train, len(docs))):
            with open(os.path.join(tmp, name), "w", newline="") as f:
                wr = csv_mod.writer(f)
                wr.writerow(["Text", "Cat1", "Cat2"])
                wr.writerows([docs[i], f"top{levels[0][i]}", int(levels[1][i]) * 5]
                             for i in range(lo, hi))
        ccfg = parse_config(["--dataset", "csv", "--data-dir", tmp, "--labels", "Cat2",
                             "--train-epochs", str(epochs), "--train-eval-every", "1",
                             "--train-verbose", "0"])
        check_ported(ccfg)
        gc, nc = flat.build_graph(ccfg)
        cres, csecs, ccounts = run_path(flat, ccfg, gc, nc, counters)
    c_steps = len(cres["history"])
    c_expected = 4 * c_steps + 2 * (c_steps + 1)
    closses = [r["loss"] for r in cres["history"]]
    log(f"  flat GCN on a CSV dataset ({len(docs)} docs, {nc} classes, N={gc.n_nodes}) in "
        f"{csecs:.1f}s: CSR launches {ccounts['csr']} (expected {c_expected}); loss "
        f"{closses[0]:.4f} -> {closses[-1]:.4f}")
    if ccounts["csr"] != c_expected or not closses[-1] < closses[0]:
        fail(f"--dataset csv: launches {ccounts}, losses {closses}")
    out["csv"] = {"docs": len(docs), "classes": nc, "seconds": csecs, "launches": ccounts["csr"]}

    # ---- --train-debug-checks: clean, then a NaN edge weight
    dcfg = parse_config(["--train-epochs", "1", "--train-verbose", "0",
                         "--train-debug-checks", "true"])
    check_ported(dcfg)
    dres, dsecs, dcounts = run_path(flat, dcfg, gc, nc, counters)
    bad_w = np.asarray(gc.edge_w).copy()
    bad_w[0] = np.nan
    raised = None
    try:
        flat.run(dcfg, dataclasses.replace(gc, edge_w=bad_w), nc)
    except FloatingPointError as exc:
        raised = str(exc)
    d_steps = len(dres["history"])
    d_expected = 4 * d_steps + 2 * (d_steps + 1)
    log(f"  --train-debug-checks: a clean epoch in {dsecs:.1f}s (loss "
        f"{dres['history'][0]['loss']:.4f}; CSR launches {dcounts['csr']}, expected "
        f"{d_expected}: the checks run on the kernel's path); a NaN edge weight raised: "
        f"{raised!r}")
    if dcounts["csr"] != d_expected or not np.isfinite(dres["history"][0]["loss"]):
        fail(f"debug checks, clean graph: {dcounts}, {dres['history']}")
    if raised is None or "nan" not in raised:
        fail("debug checks: a NaN edge weight did not raise")
    out["debug_checks"] = {"seconds": dsecs, "launches": dcounts["csr"], "raised": raised}

    # ---- --train-optimizer optax_amsgrad on the full graph
    ocfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
                         "--model-n-hidden", str(hidden), "--model-dropout", "0.7",
                         "--train-lr", "0.05", "--train-epochs", str(epochs),
                         "--train-eval-every", "1", "--train-verbose", "0",
                         "--train-optimizer", "optax_amsgrad"])
    check_ported(ocfg)
    ores, osecs, ocounts = run_path(flat, ocfg, g, n_classes, counters)
    o_steps = len(ores["history"])
    o_expected = 4 * o_steps + 2 * (o_steps + 1)
    olosses = [r["loss"] for r in ores["history"]]
    opt_name = type(ores["trainer"].optimizer).__name__
    log(f"  flat GCN --train-optimizer optax_amsgrad ({opt_name}) in {osecs:.1f}s: CSR "
        f"launches {ocounts['csr']} (expected {o_expected}); loss {olosses[0]:.4f} -> "
        f"{olosses[-1]:.4f}")
    if (ocounts["csr"] != o_expected or opt_name != "OptaxAmsgrad"
            or not np.isfinite(olosses).all() or not olosses[-1] < olosses[0]):
        fail(f"optax_amsgrad: launches {ocounts}, optimizer {opt_name}, losses {olosses}")
    out["optax_amsgrad"] = {"seconds": osecs, "launches": ocounts["csr"], "losses": olosses}
    del ores

    # ---- the batched ensemble of EGCN and of JK members
    base = ["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
            "--model-n-hidden", str(hidden), "--model-dropout", "0.7", "--train-lr", "0.05",
            "--train-epochs", str(epochs), "--train-verbose", "0"]
    out["ep"] = {}
    for name in ("egcn", "jk"):
        # EGCN at lr 0.005, as in phase 10: at 0.05 it first climbs
        lr = ["--train-lr", "0.005"] if name == "egcn" else []
        with tempfile.TemporaryDirectory() as tmp:
            ecfg = parse_config(base + lr + ["--model-model", name, "--train-ep", "true",
                                        "--result-file", os.path.join(tmp, "rows.csv")])
            check_ported(ecfg)
            for reset, _ in counters.values():
                reset()
            t0 = time.perf_counter()
            eres = perlabel.run(ecfg, g, cat1, cat2)
            torch.cuda.synchronize()
            esecs = time.perf_counter() - t0
            ecounts = {k: read() for k, (_, read) in counters.items()}
        sizes = [len(eres["mapping"][c]) for c in range(len(eres["trainers"]))]
        m_count, c_max = len(sizes), max(sizes)
        width = m_count * hidden
        e_steps = len(eres["histories"][0])
        want = ({(n, n, width): 2 * e_steps + 1, (n, n, m_count * c_max): 2 * e_steps + 1}
                if name == "egcn" else {(n, n, width): 4 * e_steps + 2})
        total = np.sum([[r["loss"] for r in h] for h in eres["histories"]], axis=0)
        log(f"  per-label --model-model {name} --train-ep in {esecs:.1f}s: {m_count} members "
            f"of {sizes} classes; CSR launches by (rows, cols, H) {ecounts['csr_shapes']} "
            f"(expected {want}); summed member loss {total[0]:.4f} -> {total[-1]:.4f}; test "
            f"acc {eres['accuracy']:.4f}, macro-F1 {eres['f1_macro']:.4f}")
        if ecounts["csr_shapes"] != want or ecounts["dual"]:
            fail(f"per-label {name} --train-ep: launches {ecounts}, expected {want}")
        # every member's losses finite (exactly 0 for a one-class member), the
        # members' summed loss falling (a member's own may bounce in 5 epochs
        # at dropout 0.7)
        member_losses = np.array([[r["loss"] for r in h] for h in eres["histories"]])
        for c, ls in enumerate(member_losses):
            if len(ls) != epochs or not np.isfinite(ls).all() or (sizes[c] == 1 and ls.any()):
                fail(f"per-label {name} --train-ep member {c}: losses {ls.tolist()}")
        if not total[-1] < total[0]:
            fail(f"per-label {name} --train-ep: the members' summed loss {total.tolist()} "
                 "did not fall")
        del eres
        # the stacked members against sequential ones from the same
        # initialization at dropout 0 (ep_against_sequential), at lr 0.005
        zcfg = parse_config(base + ["--train-lr", "0.005", "--model-model", name,
                                    "--model-dropout", "0"])
        ep_err, seq_run, excluded = ep_against_sequential(name, g, cat1, cat2, zcfg, epochs,
                                                          dev)
        torch.cuda.empty_cache()
        # step times: one batched step against the sequential members' steps
        models = [t.model for t in seq_run["trainers"]]
        params = hpl._stack_members(models, sizes, dev)
        opt = resolve_optimizer("adam", params, 0.05)
        members = hpl._member_label_arrays(g, cat2, cat1, m_count)
        ym = torch.as_tensor(np.stack([yn for _, yn, _ in members], 1), dtype=torch.int64,
                             device=dev)
        mm = torch.as_tensor(np.stack([np.asarray(g.train_mask) & nm for _, _, nm in members],
                                      1), device=dev).float()
        gens = [torch.Generator(device=dev).manual_seed(44) for _ in models]
        tadj, tfeats = seq_run["trainers"][0]._adj, seq_run["trainers"][0]._feats
        ep_step = lambda: hpl.ep_train_step(params, opt, models[0], tadj, tfeats, ym, mm, gens,
                                            sizes)
        ep_ms = host_step_ms(ep_step, reps=5, warmup=1)
        seq_ms = [host_step_ms(lambda t=t, yn=yn, nm=nm: t._train_step(
            tadj, tfeats, torch.as_tensor(yn, dtype=torch.int64, device=dev),
            torch.as_tensor(np.asarray(g.train_mask) & nm, device=dev)), reps=5, warmup=1)
            for t, (_, yn, nm) in zip(seq_run["trainers"], members)]
        entry = {"seconds": esecs, "sizes": sizes, "step_ms": ep_ms,
                 "sequential_step_ms": seq_ms, "max_abs_err_vs_sequential": ep_err,
                 "entries_at_rounding_level": excluded,
                 "launches": {str(k): c for k, c in ecounts["csr_shapes"].items()}}
        timing = ""
        if args.profile:
            entry["device_busy_ms"] = profile_step(args.profile, card,
                                                   f"per-label {name} EP step, N={n}",
                                                   f"perlabel_ep_{name}", ep_step, ep_ms)
            timing = f", device busy {entry['device_busy_ms']:.3f} ms"
        log(f"  {name} EP train step {ep_ms:.3f} ms{timing} against {sum(seq_ms):.3f} ms for "
            f"the {m_count} sequential members' steps ({[round(s, 3) for s in seq_ms]}; host "
            f"clock)")
        if name == "jk":
            # the batched LSTM against one cuDNN call a member, forward and
            # backward, at the members' shapes
            lstms = [t.model.lstm for t in seq_run["trainers"]]
            xs_l = torch.randn(m_count, n, 2, hidden, generator=gen, device=dev,
                               requires_grad=True)
            names = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0")
            stk = {sfx: [torch.stack([getattr(l, nm + sfx) for l in lstms]).detach()
                         .requires_grad_(True) for nm in names] for sfx in ("", "_reverse")}
            got = stacked_bilstm(xs_l, stk[""], stk["_reverse"]).detach()
            with torch.no_grad():
                want_l = torch.stack([l(xs_l[i])[0] for i, l in enumerate(lstms)])
                # the oracle: each member's torch.nn.LSTM in float64
                want64 = torch.stack([copy.deepcopy(l).double()(xs_l[i].double())[0]
                                      for i, l in enumerate(lstms)])
            top = float(want64.abs().max())
            err_b = float((got.double() - want64).abs().max())
            err_c = float((want_l.double() - want64).abs().max())
            log(f"  stacked_bilstm against each member's float64 torch.nn.LSTM: max_abs_err "
                f"{err_b:.3e}; the members' float32 cuDNN calls against it: {err_c:.3e}; "
                f"stacked_bilstm against those: {float((got - want_l).abs().max()):.3e} "
                f"(largest output {top:.4f})")
            allclose("stacked_bilstm vs float64 torch.nn.LSTM, 1e-5 of the largest output",
                     got.double(), want64, 0.0, 1e-5 * top)
            ct_l = torch.randn_like(got)
            batched_ms = time_ms(lambda: torch.autograd.grad(
                (stacked_bilstm(xs_l, stk[""], stk["_reverse"]) * ct_l).sum(),
                [xs_l] + stk[""] + stk["_reverse"]), 5, warmup=1)
            cudnn_ms = time_ms(lambda: [torch.autograd.grad(
                (l(xs_l[i])[0] * ct_l[i]).sum(), [xs_l] + list(l.parameters()))
                for i, l in enumerate(lstms)], 5, warmup=1)
            entry.update(lstm_batched_ms=batched_ms, lstm_cudnn_ms=cudnn_ms)
            log(f"  JK LSTM forward + backward, {m_count} members at [{n}, 2, {hidden}]: "
                f"batched {batched_ms:.3f} ms, {m_count} cuDNN calls {cudnn_ms:.3f} ms")
            del xs_l, stk, got, want_l, ct_l
        out["ep"][name] = entry
        del seq_run, params, opt, models
        torch.cuda.empty_cache()
    torch.cuda.synchronize()
    return out, errs, plan_rows


def counting_and_minibatching(args, card, cfg, g, n_classes: int, adj, counters, gen, dev):
    """Phase 13: device counting on the 50k-doc corpus against the native
    kernel at two chunk budgets, ``Text2Graph(backend='auto')`` above the
    native limit, the flat experiment with ``--train-batch-size`` (the first
    batch's plans and logits checked, the kernel at the subgraph plans, the
    per-batch split), and the loss falling on mini-batches of a 3,000-doc
    corpus. Returns (summary, kernel errors, subgraph plan rows)."""
    import copy

    import numpy as np
    import torch

    from pytextgcn_tpu_torch.build import windows
    from pytextgcn_tpu_torch.build.stopwords import get_stopwords
    from pytextgcn_tpu_torch.build.vectorizer import CountVectorizer
    from pytextgcn_tpu_torch.config import check_ported, make_model, parse_config
    from pytextgcn_tpu_torch.data.batching import NeighborhoodBatcher
    from pytextgcn_tpu_torch.experiments import common, flat
    from pytextgcn_tpu_torch.ops import NodeFeatures, spmm_cuda
    from pytextgcn_tpu_torch.train import Trainer

    kernel, plain, mag = (spmm_cuda.spmm_csr_kernel, spmm_cuda.spmm_csr_reference,
                          spmm_cuda.spmm_csr_abs)
    out, errs = {}, []
    log("[13/14] device counting and mini-batching:")

    # ---- device counting against native on the corpus of phase 2
    gc = cfg.graph
    docs, _, test_idx, val_idx = common.load_corpus(cfg)
    cv = CountVectorizer(min_df=gc.min_df, max_df=gc.max_df,
                         stop_words=get_stopwords("nltk") if gc.rm_stopwords else None)
    cv.fit_transform(docs)
    tokens = cv.encode_documents(docs, gc.max_length)
    n_vocab = len(cv.vocabulary_)
    if n_vocab != g.n_vocab:
        fail(f"recomputed vocabulary {n_vocab} != the graph's {g.n_vocab}")
    t0 = time.perf_counter()
    native = windows.word_word_edges(tokens, n_vocab, gc.window_size, backend="native",
                                     n_jobs=8)
    native_s = time.perf_counter() - t0
    tri_gb = n_vocab * (n_vocab + 1) // 2 * 4 / 1e9
    log(f"  tokens [{tokens.shape[0]}, {tokens.shape[1]}], V={n_vocab} (native triangle "
        f"{tri_gb:.2f} GB); native count {native_s:.2f}s: {len(native[1])} word-word edges, "
        f"{native[2]} windows")
    counting = []
    for budget in (1 << 24, 1 << 26, 1 << 24):
        n_chunks = sum(1 for _ in windows._iter_chunks(tokens, gc.window_size, budget))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = windows.word_word_edges_device(tokens, n_vocab, gc.window_size,
                                             chunk_pair_budget=budget, device=dev)
        secs = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
        same = (got[2] == native[2] and np.array_equal(got[0], native[0])
                and got[1].tobytes() == native[1].tobytes())
        counting.append({"chunk_pair_budget": budget, "chunks": n_chunks, "seconds": secs,
                         "peak_memory_gb": peak_gb, "bitwise_equal": same})
        log(f"  device count, budget 2^{budget.bit_length() - 1}: {secs:.2f}s, {n_chunks} "
            f"chunks, peak device memory {peak_gb:.2f} GB above the baseline; equal to "
            f"native bit for bit: {same}")
        if not same:
            fail(f"device counting at budget {budget} differs from the native kernel")
    out["counting"] = {"tokens_shape": list(tokens.shape), "n_vocab": n_vocab,
                       "native_s": native_s, "device": counting}
    del tokens, native, got

    # 'auto' above the native limit, for this build only
    old = os.environ.get("PYTEXTGCN_NATIVE_TRI_BYTES")
    os.environ["PYTEXTGCN_NATIVE_TRI_BYTES"] = str(int(tri_gb * 1e9) - 1)
    try:
        t0 = time.perf_counter()
        ga = common.build_graph(gc, docs, np.asarray(g.y)[g.n_vocab:], test_idx, val_idx,
                                verbose=0, device=dev)
        auto_s = time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["PYTEXTGCN_NATIVE_TRI_BYTES"]
        else:
            os.environ["PYTEXTGCN_NATIVE_TRI_BYTES"] = old
    same = all(np.asarray(getattr(ga, f)).tobytes() == np.asarray(getattr(g, f)).tobytes()
               for f in ("edge_src", "edge_dst", "edge_w", "train_mask", "val_mask",
                         "test_mask", "y"))
    log(f"  Text2Graph(backend='auto') above the native limit: {auto_s:.1f}s, the graph of "
        f"phase 2 bit for bit: {same}")
    if not same:
        fail("Text2Graph(backend='auto') on the device path built another graph")
    out["counting"]["auto_graph_s"] = auto_s
    del ga, docs

    # ---- mini-batching through the flat experiment
    bsize = 4096
    bcfg = copy.deepcopy(cfg)
    bcfg.train.batch_size = bsize
    bcfg.train.epochs = 1
    check_ported(bcfg)
    # the run's first batch (the trainer's batcher has the run's seed)
    batcher = NeighborhoodBatcher(g, batch_size=bsize, n_hops=2, seed=bcfg.train.seed,
                                  pad_pow2=False)
    t0 = time.perf_counter()
    sub = next(iter(batcher))
    batch_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    badj = sub.to_adj(dev)
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    ne = sub.n_real_edges
    t0 = time.perf_counter()
    host = spmm_cuda.build_plan_from_arrays(sub.edge_src[:ne], sub.edge_dst[:ne],
                                            sub.edge_w[:ne], sub.n_real_nodes, device=dev)
    host_s = time.perf_counter() - t0
    for pname in ("fwd", "bwd"):
        a, b = getattr(badj.plan, pname), getattr(host, pname)
        for f in ("row_ptr", "pairs", "seg_ptr", "seg_row", "seg_slot", "split_row",
                  "split_ptr"):
            if not torch.equal(getattr(a, f), getattr(b, f)):
                fail(f"first batch: the {pname} plan built on the card differs in {f}")
        if a.n_partials != b.n_partials:
            fail(f"first batch: {pname} n_partials {a.n_partials} != {b.n_partials}")
    log(f"  first batch of {bsize}: {sub.n_real_nodes} nodes, {ne} edges; batcher "
        f"{batch_s:.3f}s, plans on the card {plan_s:.3f}s, on the host {host_s:.3f}s; the "
        f"card's plans equal the host's bit for bit")
    # its batch-node logits against the full graph's, from the run's initial
    # parameters
    model = make_model(bcfg.model, g.in_dim, n_classes,
                       generator=torch.Generator().manual_seed(bcfg.train.seed)).to(dev)
    feats = NodeFeatures.from_graph(g, device=dev)
    nodes = torch.as_tensor(sub.nodes[:badj.n_nodes], device=dev)
    locs = torch.as_tensor(sub.batch_local, device=dev, dtype=torch.int64)
    with torch.no_grad():
        full = model(adj, feats)
        part = model(badj, feats.subgraph(nodes))
    compare(f"batch-node logits of the first batch ({len(sub.batch_local)} documents) vs "
            "the full graph", part[locs], full[nodes[locs]], full.abs().max(), LOGIT_RTOL)
    del model, full, part
    # the kernel at the subgraph's plans, at both widths of the step
    plan_rows = []
    for h in (cfg.model.n_hidden, n_classes):
        for pname in ("fwd", "bwd"):
            csr = getattr(badj.plan, pname)
            x = torch.randn(csr.n_cols, h, generator=gen, device=dev)
            err = compare(f"subgraph {pname} [{csr.n_rows}, {csr.n_cols}] H={h}",
                          kernel(csr, x), plain(csr, x), mag(csr, x), F32_RTOL)
            errs.append(err)
            lib = sparse_csr(csr)
            _, _, bound, bound_by = spmm_work(csr, h, 4)
            row = {"plan": f"subgraph {pname}", "n_rows": csr.n_rows, "n_cols": csr.n_cols,
                   "h": h, "edges": csr.n_edges, "max_abs_err": err,
                   "ms": time_ms(lambda: kernel(csr, x), 50),
                   "plain_ms": time_ms(lambda: plain(csr, x), 5, warmup=1),
                   "library_ms": time_ms(lambda: torch.sparse.mm(lib, x), 20),
                   "bound_ms": bound, "bound_by": bound_by}
            plan_rows.append(row)
            log(f"  spmm_csr {row['plan']} H={h} ({csr.n_edges} edges): kernel "
                f"{row['ms']:.4f} ms, bound {bound:.4f} ms by {bound_by}, plain "
                f"{row['plain_ms']:.4f} ms, torch.sparse.mm {row['library_ms']:.4f} ms")
    if args.profile:
        # the step alone on the first batch's subgraph (no batcher, no plan)
        ptrainer = Trainer(make_model(bcfg.model, g.in_dim, n_classes,
                                      generator=torch.Generator().manual_seed(0)),
                           lr=0.05, device=dev)
        y = torch.as_tensor(np.asarray(g.y, np.int64), device=dev)[nodes]
        mask = torch.zeros(badj.n_nodes, dtype=torch.bool, device=dev)
        mask[locs] = True
        bfeats = feats.subgraph(nodes)
        step = lambda: ptrainer._train_step(badj, bfeats, y, mask)
        step_ms = host_step_ms(step)
        out["minibatch_step_ms"] = step_ms
        out["minibatch_step_busy_ms"] = profile_step(
            args.profile, card, f"mini-batch step, first batch of {bsize}: "
            f"{sub.n_real_nodes} nodes, {ne} edges", "minibatch", step, step_ms)
        del ptrainer, bfeats
    del badj, host, sub, feats, batcher
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, secs, counts = run_path(flat, bcfg, g, n_classes, counters)
    peak_gb = (torch.cuda.max_memory_allocated() - base) / 1e9
    split = res["trainer"].minibatch_seconds
    n_batches = len(split)
    want = 4 * n_batches + 2
    losses = [r["loss"] for r in res["history"]]
    mean = {k: sum(t[k] for t in split) / n_batches for k in ("batcher", "plan", "step")}
    log(f"  flat --train-batch-size {bsize}, 1 epoch, in {secs:.1f}s: {n_batches} batches, "
        f"CSR launches {counts['csr']} (expected {want}); mean loss {losses}; test acc "
        f"{res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}; peak memory {peak_gb:.2f} GB "
        "above the baseline")
    log(f"  per batch (host clock, synchronized): batcher {mean['batcher']:.3f}s, plans "
        f"{mean['plan']:.4f}s, step {mean['step']:.4f}s; each: "
        + "; ".join(f"{t['batcher']:.3f}/{t['plan']:.4f}/{t['step']:.4f}" for t in split))
    if n_batches != -(-int(np.sum(g.train_mask)) // bsize):
        fail(f"mini-batch run: {n_batches} batches")
    if counts["csr"] != want or counts["dual"]:
        fail(f"mini-batch run: launches {counts}, expected {want} CSR launches")
    if len(losses) != 1 or not np.isfinite(losses).all():
        fail(f"mini-batch run: losses {losses}")
    if not (0.0 <= res["accuracy"] <= 1.0 and np.isfinite(res["f1_macro"])):
        fail(f"mini-batch run: metrics {res['accuracy']}, {res['f1_macro']}")
    out["minibatch"] = {"batch_size": bsize, "batches": n_batches, "seconds": secs,
                        "launches": counts["csr"], "loss": losses, "peak_memory_gb": peak_gb,
                        "first_batch": {"nodes": plan_rows[0]["n_rows"],
                                        "edges": plan_rows[0]["edges"], "batcher_s": batch_s,
                                        "card_plan_s": plan_s, "host_plan_s": host_s},
                        "mean_seconds": mean, "seconds_each": split,
                        "accuracy": res["accuracy"], "f1_macro": res["f1_macro"]}
    del res

    # ---- the loss falls on mini-batches of a 3,000-doc corpus
    ccfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", "3000",
                         "--model-n-hidden", str(cfg.model.n_hidden), "--model-dropout", "0.7",
                         "--train-lr", "0.05", "--train-epochs", "5",
                         "--train-batch-size", "128", "--train-verbose", "0"])
    check_ported(ccfg)
    gs, ncs = flat.build_graph(ccfg)
    res, secs, counts = run_path(flat, ccfg, gs, ncs, counters)
    losses = [r["loss"] for r in res["history"]]
    n_b = len(res["trainer"].minibatch_seconds)
    log(f"  3,000 docs, batch 128, 5 epochs in {secs:.1f}s: {n_b} batches, CSR launches "
        f"{counts['csr']} (expected {4 * n_b + 2}); mean loss a epoch "
        f"{[round(x, 4) for x in losses]}; test acc {res['accuracy']:.4f}")
    if counts["csr"] != 4 * n_b + 2 or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"mini-batches of the 3,000-doc corpus: launches {counts}, losses {losses}")
    out["convergence"] = {"n_docs": 3000, "batch_size": 128, "batches": n_b, "seconds": secs,
                          "losses": losses, "accuracy": res["accuracy"]}
    return out, errs, plan_rows


def probe_against_spec(card, dev):
    """Phase 14 (a): the probe's readings, each within ``PEAK_SLACK`` of the
    H100's data-sheet peak, beside the cost model's constants. Returns
    (summary, the probe)."""
    from pytextgcn_tpu_torch.ops import hybrid
    from pytextgcn_tpu_torch.ops.probe import _BAG, probe_chip

    pr = probe_chip(device=dev)
    # the gathers' bytes to and from HBM a row: the copy writes its 512-byte
    # row and reads an 8-byte index; the gather-sum reads the index and
    # writes one row a bag (the table, 26 MB, is read from L2)
    rows = [
        ("gather-sum bytes/s (index + sums)", (8 + 512 / _BAG) / (pr.gather_ns * 1e-9),
         spec_peak("hbm_gbps"), None),
        ("gather-copy bytes/s (row + index)", (512 + 8) / (pr.gather_copy_ns * 1e-9),
         spec_peak("hbm_gbps"), None),
        ("stream B/s", pr.stream_bps, spec_peak("hbm_gbps"), ("_HBM_BPS", hybrid._HBM_BPS)),
        ("D-read B/s", pr.hbm_bps, spec_peak("hbm_gbps"), ("_HBM_BPS", hybrid._HBM_BPS)),
        ("f32 flop/s", pr.mxu_f32_fps, spec_peak("f32_tflops"),
         ("_MXU_F32_HIGHEST", hybrid._MXU_F32_HIGHEST)),
        ("TF32 flop/s", pr.mxu_tf32_fps, spec_peak("tf32_tflops"), None),
        ("bf16 flop/s", pr.mxu_bf16_fps, spec_peak("bf16_tflops"),
         ("_MXU_BF16_FACTOR x _MXU_F32_HIGHEST",
          hybrid._MXU_BF16_FACTOR * hybrid._MXU_F32_HIGHEST)),
    ]
    log(f"  (a) probe in {pr.probe_s:.1f}s on {card} (slope fell back for "
        f"{list(pr.fallbacks)}): gather {pr.gather_ns:.4f} ns a row summed, "
        f"{pr.gather_copy_ns:.4f} copied out")
    out = {"gather_ns": pr.gather_ns, "gather_copy_ns": pr.gather_copy_ns,
           "fallbacks": list(pr.fallbacks), "readings": []}
    for name, got, peak, fitted in rows:
        line = f"    {name}: {got:.4g}, {got / peak:.3f} of the spec peak {peak:.4g}"
        if fitted:
            line += f"; phase 11's {fitted[0]} {fitted[1]:.4g} (probe / fitted {got / fitted[1]:.3f})"
        log(line)
        out["readings"].append({"name": name, "value": got, "peak": peak,
                                "of_peak": got / peak,
                                **({"fitted": fitted[1]} if fitted else {})})
        if not 0 < got <= PEAK_SLACK * peak:
            fail(f"probe {name} = {got:.4g} is not within {PEAK_SLACK} of the spec peak {peak:.4g}")
    # the floor's price of a residual edge: its index and weight at the
    # stream rate; it must lie below the CSR kernel's edge at every width
    log(f"    _GATHER_NS in use (ops/hybrid.py, the floor's price of a residual edge, "
        f"{hybrid.RESID_EDGE_BYTES} bytes at {hybrid._STREAM_BPS:.4g} B/s): "
        f"{hybrid._GATHER_NS:.6f} ns; at this run's stream rate {pr.resid_edge_ns:.6f} "
        f"(in use / probed {hybrid._GATHER_NS / pr.resid_edge_ns:.3f}); the CSR kernel's "
        f"edge at H = 43 / 100: {hybrid.csr_edge_ns(43)} / {hybrid.csr_edge_ns(100)} ns")
    if not 0 < hybrid._GATHER_NS < min(hybrid._CSR_EDGE_NS.values()):
        fail(f"ops/hybrid.py's _GATHER_NS {hybrid._GATHER_NS} is not below the CSR kernel's edge")
    out["gather_ns_in_use"] = hybrid._GATHER_NS
    out["resid_edge_ns"] = pr.resid_edge_ns
    return out, pr


def tooling_and_drivers(args, card, g, dev, pr) -> dict:
    """Phase 14 (b)-(e) and (g): the bench's variant loop on phase 2's
    graph, the hyperopt, benchmark_graph and protocol drivers, and
    tune_allocator's effect, each fatal."""
    import shutil

    import numpy as np

    from pytextgcn_tpu_torch import bench
    from pytextgcn_tpu_torch.experiments import benchmark_graph, hyperopt, protocol
    from pytextgcn_tpu_torch.ops import fused_dual as fd
    from pytextgcn_tpu_torch.ops import spmm_cuda

    kernel, dual = spmm_cuda.spmm_csr_kernel, fd.fused_dual_kernel
    out = {}

    # ---- (b) the bench's variants on phase 2's graph
    t0 = time.perf_counter()
    os.makedirs(bench.PLAN_CACHE, exist_ok=True)
    cache = tempfile.mkdtemp(prefix="smoke-", dir=bench.PLAN_CACHE)
    traces = tempfile.mkdtemp(prefix="smoke-traces-")
    try:
        # the floor paths' device busy time, which the floors must not exceed
        res = bench.bench_scale(g, bench.variants(cache), dev, epochs=BENCH_EPOCHS,
                                profile_dir=traces, tag="smoke",
                                profile_names={"hybrid f32", f"hybrid f32 K{bench.EXPLICIT_K}"})
    except RuntimeError as e:  # a variant's launches differ from its plans'
        fail(f"bench: {e}")
    finally:
        shutil.rmtree(cache, ignore_errors=True)
        shutil.rmtree(traces, ignore_errors=True)
    dual_key = {"hybrid f32": "split", "hybrid f32.highest": "f32", "hybrid bf16": "bf16"}
    for name, per_step in res["launches_per_step"].items():
        want_csr = 0 if name == "segment f32" else 4
        want_dual = {}
        if f"K{bench.EXPLICIT_K}" in name:
            base = name.split(f" K{bench.EXPLICIT_K}")[0]
            want_dual = {dual_key[base]: 2 if name.endswith("masked-head") else 4}
        if per_step["spmm_csr"] != want_csr or (want_dual and per_step["dual"] != want_dual):
            fail(f"bench {name}: launches a step {per_step}, expected spmm_csr {want_csr}, "
                 f"dual {want_dual or 'as its plan implies'}")
    line = bench.headline(g, res, res, pr, dev, {}, [])
    bad = bench.check_fractions(line)
    log(f"  (b) bench variants on phase 2's graph in {time.perf_counter() - t0:.1f}s "
        f"({bench.WARMUP_STEPS} + {bench.TIMING_BLOCKS} x {BENCH_EPOCHS} steps each): "
        f"step ms {line['step_ms']}; K {line['hybrid_k']}; roofline "
        f"{line['fraction_of_roofline']} (probed stream {line['fraction_of_roofline_probed']}), "
        f"floor {line['fraction_of_achievable']} (probed "
        f"{line['fraction_of_achievable_probed']}; of the device busy time "
        f"{line.get('fraction_of_achievable_busy')}, probed "
        f"{line.get('fraction_of_achievable_probed_busy')}; {line['floor_check']}, "
        f"{line.get('floor_path')}); x_of_gather_floor {line['x_of_gather_floor']}")
    if line.get("floor_path") and "fraction_of_achievable_busy" not in line:
        fail(f"bench: no device busy time for the floor path {line['floor_path']}")
    if bad:
        fail("bench fractions: " + "; ".join(bad))
    out["bench"] = {k: line[k] for k in (
        "step_ms", "step_ms_spread", "hybrid_k", "launches_per_step", "fraction_of_roofline",
        "fraction_of_roofline_probed", "fraction_of_achievable",
        "fraction_of_achievable_probed", "floor_check", "x_of_gather_floor", "best_path")}
    out["bench"].update({k: line.get(k) for k in (
        "fraction_of_achievable_busy", "fraction_of_achievable_probed_busy")})

    tmp = tempfile.mkdtemp(prefix="smoke14-")
    try:
        # ---- (c) hyperopt: a 2-fold grid at 3,000 documents
        for hierarchy in ("flat", "per-label"):
            t0 = time.perf_counter()
            before = kernel.launches
            rows = hyperopt.main([
                "--dataset", "synthetic-amazon", "--n-docs", "3000", "--hierarchy", hierarchy,
                "--k-split", "2", "--epochs", str(HYPEROPT_EPOCHS), "--lrs", "0.05",
                "--dropouts", "0.5", "--max-dfs", "0.7", "--models", "GCN",
                "--out", os.path.join(tmp, f"ho_{hierarchy}.csv")])
            launches = kernel.launches - before
            # each fold's fit: 4 a step, 2 an evaluation every epoch, 2 more
            # for the fold's evaluate
            want = len(rows) * 2 * (6 * HYPEROPT_EPOCHS + 2)
            f1s = [r["mean f1"] for r in rows]
            log(f"  (c) hyperopt {hierarchy}, 3,000 docs, 2 folds: {len(rows)} rows in "
                f"{time.perf_counter() - t0:.1f}s, mean f1 {np.round(f1s, 4).tolist()}; CSR "
                f"launches {launches} (expected {want})")
            if not np.isfinite(f1s).all() or launches != want:
                fail(f"hyperopt {hierarchy}: rows {rows}, launches {launches} != {want}")
            out[f"hyperopt_{hierarchy}"] = {"rows": len(rows), "launches": launches,
                                            "seconds": time.perf_counter() - t0}

        # ---- (d) benchmark_graph: native and device at 3,000 documents
        gb = benchmark_graph.main(["--n-docs", "3000", "--backends", "native", "device",
                                   "--plan-bench"])
        log(f"  (d) benchmark_graph, 3,000 docs: "
            + ", ".join(f"{r['backend']} {r['seconds']:.3f}s" for r in gb["backends"])
            + f", {gb['backends'][0]['n_edges']} edges, equal: {gb['edges_equal']}; plan K="
            f"{gb['plan']['k']} cold {gb['plan']['cold_s']:.3f}s, warm "
            f"{gb['plan']['warm_s']:.3f}s")
        if not gb["edges_equal"]:
            fail("benchmark_graph: the backends' edges differ")
        out["benchmark_graph"] = gb

        # ---- (e) the protocol driver's hybrid flags, 5 epochs on the 50k
        # corpus, both modes on one build of its graph
        t0 = time.perf_counter()
        pgraph = protocol.build_graph("amazon", args.n_docs, verbose=0, device=dev)
        log(f"  (e) the protocol's amazon graph in {time.perf_counter() - t0:.1f}s: "
            f"N={pgraph[0].n_nodes} E={pgraph[0].n_edges}")
        for mode, flags in (("split", ["--hybrid-f32-mode", "split2"]),
                            ("bf16", ["--pallas-dtype", "bfloat16"])):
            t0 = time.perf_counter()
            dual.launches = {}
            before = kernel.launches
            prow = protocol.main(["--protocol", "amazon", "--n-docs", str(args.n_docs),
                                  "--epochs", "5", "--seeds", "42",
                                  "--hybrid-k", str(bench.EXPLICIT_K), *flags,
                                  "--out", os.path.join(tmp, "rows.csv"), "--verbose", "0"],
                                 graph=pgraph)
            # 4 a step, 2 an evaluation (every epoch at 5 epochs), 2 more
            want = 4 * 5 + 2 * 5 + 2
            got, csr = dict(dual.launches), kernel.launches - before
            log(f"  (e) protocol --hybrid-k {bench.EXPLICIT_K} {' '.join(flags)}, 5 epochs in "
                f"{time.perf_counter() - t0:.1f}s: dual launches {got}, CSR (residual) {csr} "
                f"(expected {want} each); f1 {prow[0]['f1_macro']:.4f}")
            if got != {mode: want} or csr != want or not np.isfinite(prow[0]["final_loss"]):
                fail(f"protocol {mode}: dual {got}, CSR {csr}, expected {want}")
            out[f"protocol_{mode}"] = {"dual": got, "csr": csr}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # ---- (g) tune_allocator on and off, each in a process of its own
    out["allocator"] = {}
    for name, extra in (("tuned", {}), ("untuned", {"PYTEXTGCN_NO_MALLOPT": "1"})):
        env = {k: v for k, v in os.environ.items() if k != "PYTEXTGCN_NO_MALLOPT"}
        env.update(extra, PYTHONPATH=ROOT)
        r = subprocess.run([sys.executable, os.path.abspath(__file__), "--allocator-timing",
                            "--n-docs", str(args.n_docs)],
                           capture_output=True, text=True, timeout=900, env=env)
        if r.returncode != 0:
            log(r.stderr[-4000:])
            fail(f"allocator timing ({name}) failed")
        rec = json.loads(r.stdout.strip().splitlines()[-1])
        if rec["tuned"] != (name == "tuned"):
            fail(f"allocator timing ({name}): tune_allocator returned {rec['tuned']}")
        out["allocator"][name] = rec
        log(f"  (g) {name} (mallopt {'on' if rec['tuned'] else 'off'}): host graph build "
            f"{rec['graph_s']:.2f}s, CSR plans {rec['plan_s']:.2f}s")
    return out


def allocator_timing(n_docs: int) -> int:
    """Phase 14 (g)'s child: the host graph build and the CSR plan build of
    the 50k-doc synthetic-amazon graph, timed; prints one JSON line with
    whether ``tune_allocator`` applied (``PYTEXTGCN_NO_MALLOPT``)."""
    import torch

    from pytextgcn_tpu_torch import utils
    from pytextgcn_tpu_torch.config import parse_config
    from pytextgcn_tpu_torch.experiments import common
    from pytextgcn_tpu_torch.ops import NormAdj

    cfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", str(n_docs)])
    docs, labels, test_idx, val_idx = common.load_corpus(cfg)
    t0 = time.perf_counter()
    g = common.build_graph(cfg.graph, docs, labels[0], test_idx, val_idx, verbose=0,
                           device="cuda")
    graph_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    NormAdj.from_graph(g, use_pallas=True, device="cuda")
    torch.cuda.synchronize()
    plan_s = time.perf_counter() - t0
    print(json.dumps({"tuned": utils._tuned, "graph_s": graph_s, "plan_s": plan_s,
                      "n_edges": g.n_edges}), flush=True)
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables of 5 train steps on the CSR "
                         "kernel path, on the hybrid path and on each phase-10 path")
    ap.add_argument("--allocator-timing", action="store_true",
                    help="only the graph and plan builds, timed (phase 14)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pytextgcn_tpu_torch")):
        fail("pytextgcn_tpu_torch/ is not beside this script: run it from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    sys.path.insert(0, ROOT)
    if args.allocator_timing:
        return allocator_timing(args.n_docs)
    import numpy as np

    from pytextgcn_tpu_torch.build.native_bridge import load_native
    from pytextgcn_tpu_torch.config import check_ported, make_model, parse_config
    from pytextgcn_tpu_torch.core.graph import TextGraph
    from pytextgcn_tpu_torch.experiments import flat
    from pytextgcn_tpu_torch.ops import NodeFeatures, NormAdj
    from pytextgcn_tpu_torch.ops import fused_dual as fd
    from pytextgcn_tpu_torch.ops import spmm_cuda
    from pytextgcn_tpu_torch.ops.hybrid import spmm_hybrid
    from pytextgcn_tpu_torch.ops.spmm import spmm, spmm_segment
    from pytextgcn_tpu_torch.train import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kernel = spmm_cuda.spmm_csr_kernel
    plain = spmm_cuda.spmm_csr_reference
    mag = spmm_cuda.spmm_csr_abs
    dual = fd.fused_dual_kernel
    t_start = time.perf_counter()

    # ------------------------------------------------------------ 1. build
    card = card_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    # timing builds (phase 9), never used for results: the f32 variant with
    # one TF32 pass, and with three passes fed raw f32 without the split;
    # the split variant with one bf16 pass; the split and bf16 variants with
    # float4 atomics in place of the bulk reduction
    f32_timing = {"1 pass": fd.FusedDualKernel(["-DFD_TF32_PASSES=1"], "_1pass"),
                  "no split": fd.FusedDualKernel(["-DFD_TF32_NO_SPLIT"], "_nosplit")}
    split_1pass = fd.FusedDualKernel(["-DFD_SPLIT_PASSES=1"], "_split1pass")
    hot_float4 = fd.FusedDualKernel(["-DFD_HOT_ATOMICS"], "_hotatomics")
    csr_timing = {name: spmm_cuda.SpmmCsrKernel(flags, "_" + name)
                  for name, (flags, _) in CSR_TIMING_BUILDS.items()}
    with ThreadPoolExecutor(10) as pool:
        builds = [pool.submit(kernel.build, True), pool.submit(dual.build, True)]
        timing_builds = [pool.submit(v.build)
                         for v in (*f32_timing.values(), split_1pass, hot_float4,
                                   *csr_timing.values())]
        native_build = pool.submit(load_native)
        ptxas = [b.result() for b in builds]
        for b in timing_builds:
            b.result()
        native_build.result()
    log(f"[1/14] built the two CUDA kernels (and {len(csr_timing)} timing builds of the CSR "
        f"kernel, four of the dual kernel) and the native library in "
        f"{time.perf_counter() - t0:.1f}s; ptxas:")
    for out in ptxas:
        for line in out.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"    {line.strip()}")

    # ------------------------------------------------------------ 2. graph
    hidden = 100
    cfg = parse_config([
        "--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
        "--model-n-hidden", str(hidden), "--model-dropout", "0.7",
        "--train-lr", "0.05", "--train-epochs", str(args.epochs),
        "--train-eval-every", "1", "--train-verbose", "0",
        "--train-use-pallas", "true",
    ])
    check_ported(cfg)
    t0 = time.perf_counter()
    g, n_classes = flat.build_graph(cfg)
    n, e = g.n_nodes, g.n_edges
    log(f"[2/14] graph in {time.perf_counter() - t0:.1f}s: N={n} E={e} "
        f"(vocab {g.n_vocab}, docs {g.n_docs}), {n_classes} classes")
    widths = (hidden, n_classes)

    # ------------------------------------------------------------ 3. check
    t0 = time.perf_counter()
    adj = NormAdj.from_graph(g, use_pallas=True, device=dev)
    plan = adj.plan
    log(f"[3/14] plan in {time.perf_counter() - t0:.1f}s: {plan.fwd.seg_row.shape[0]} "
        f"segments, {plan.fwd.n_partials} partial rows (fwd); checks:")
    gen = torch.Generator(device=dev).manual_seed(0)
    f32_errs, bf16_errs = [], []
    for pname, csr in (("fwd", plan.fwd), ("bwd", plan.bwd)):
        for h in widths:
            x = torch.randn(n, h, generator=gen, device=dev)
            got = kernel(csr, x)
            f32_errs.append(compare(f"f32 {pname} H={h}", got, plain(csr, x),
                                    mag(csr, x), F32_RTOL))
            if not torch.equal(got, kernel(csr, x)):
                fail(f"f32 {pname} H={h}: two launches differ")
            xb = x.bfloat16()
            gotb = kernel(csr, xb)
            bf16_errs.append(compare(f"bf16 {pname} H={h} vs plain on the same bf16 x",
                                     gotb, plain(csr, xb), mag(csr, xb), F32_RTOL))
            compare(f"bf16 {pname} H={h} vs plain on f32 x", gotb, plain(csr, x),
                    mag(csr, x), BF16_RTOL)
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev, requires_grad=True)
        gout = torch.randn(n, h, generator=gen, device=dev)
        before = kernel.launches
        (spmm_cuda.spmm_plan(plan, x) * gout).sum().backward()
        if kernel.launches != before + 2:
            fail(f"autograd H={h}: {kernel.launches - before} launches, expected 2")
        f32_errs.append(compare(f"gradient H={h} (transpose plan)", x.grad,
                                plain(plan.bwd, gout), mag(plan.bwd, gout), F32_RTOL))
        with torch.no_grad():
            scale = mag(plan.fwd, x) + adj.self_w[:, None] * x.abs()
            f32_errs.append(compare(f"A_hat @ x with diagonal H={h} vs spmm_segment",
                                    spmm(adj, x), spmm_segment(adj, x), scale, F32_RTOL))
    small = spmm_cuda.build_plan_from_arrays(
        np.array([0, 1, 2, 2]), np.array([1, 0, 3, 0]), np.ones(4, np.float32), 50,
        device=dev)
    xs = torch.randn(50, 8, generator=gen, device=dev)
    out = kernel(small.fwd, xs)
    if out[4:].any() or out[2].any():
        fail("isolated nodes: rows with no edges are not exact zeros")
    f32_errs.append(compare("small graph with isolated nodes", out, plain(small.fwd, xs),
                            mag(small.fwd, xs), F32_RTOL))
    empty = spmm_cuda.build_plan_from_arrays(np.zeros(0), np.zeros(0), np.zeros(0), 50,
                                             device=dev)
    if kernel(empty.fwd, xs).any():
        fail("empty graph: output is not all zeros")
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 4. main path
    counters = {
        "csr": (lambda: setattr(kernel, "launches", 0), lambda: kernel.launches),
        "csr_shapes": (lambda: setattr(kernel, "shapes", {}), lambda: dict(kernel.shapes)),
        "dual": (lambda: setattr(dual, "launches", {}), lambda: dict(dual.launches)),
    }
    torch.cuda.reset_peak_memory_stats()
    res, main_s, counts = run_path(flat, cfg, g, n_classes, counters)
    launches = counts["csr"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    hist = res["history"]
    steps = len(hist)
    evals = sum("val_f1" in rec for rec in hist) + 1  # + evaluate()
    expected = 4 * steps + 2 * evals
    losses = [rec["loss"] for rec in hist]
    log(f"[4/14] main path in {main_s:.1f}s: {steps} train steps, {evals} forward-only "
        f"passes, kernel launches {launches} (expected {expected}); loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; test acc {res['accuracy']:.4f}, "
        f"macro-F1 {res['f1_macro']:.4f}; peak memory {peak_gb:.2f} GB")
    log(f"  results row: {res['row']}")
    if launches != expected or counts["dual"]:
        fail(f"the main path launched the kernels {counts}, expected {expected} CSR launches")
    if steps != args.epochs or not np.isfinite(losses).all():
        fail(f"training: {steps} steps, losses {losses}")
    if not losses[-1] < losses[0]:
        fail(f"training did not lower the loss: {losses[0]} -> {losses[-1]}")
    if not (0.0 <= res["accuracy"] <= 1.0 and 0.0 <= res["f1_macro"] <= 1.0):
        fail(f"metrics out of range: {res}")
    # the model on this graph: kernel aggregation against the plain path
    model = make_model(cfg.model, g.in_dim, n_classes,
                       generator=torch.Generator().manual_seed(1)).to(dev)
    feats = NodeFeatures.from_graph(g, device=dev)
    plain_adj = NormAdj(src=adj.src, dst=adj.dst, w=adj.w, self_w=adj.self_w, n_nodes=n)
    with torch.no_grad():
        logits = model(adj, feats)
        want = model(plain_adj, feats)
    if tuple(logits.shape) != (n, n_classes):
        fail(f"logits shape {tuple(logits.shape)}, expected {(n, n_classes)}")
    compare("GCN logits, kernel vs plain path (full graph)", logits, want,
            want.abs().max(), LOGIT_RTOL)
    # small input: the card's kernel path against the CPU's plain version
    rng = np.random.default_rng(5)
    sv, sd, se = 300, 400, 8000
    sg = TextGraph(
        edge_src=rng.integers(0, sv + sd, se).astype(np.int32),
        edge_dst=rng.integers(0, sv + sd, se).astype(np.int32),
        edge_w=rng.random(se).astype(np.float32),
        y=rng.integers(0, 5, sv + sd).astype(np.int32),
        train_mask=np.r_[np.zeros(sv, bool), np.ones(sd, bool)],
        val_mask=np.zeros(sv + sd, bool), test_mask=np.zeros(sv + sd, bool),
        n_vocab=sv, n_docs=sd)
    smodel = make_model(cfg.model, sg.in_dim, 5, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        cpu = smodel(NormAdj.from_graph(sg, use_pallas=True, device="cpu"),
                     NodeFeatures.from_graph(sg, device="cpu"))
        smodel.to(dev)
        gpu = smodel(NormAdj.from_graph(sg, use_pallas=True, device=dev),
                     NodeFeatures.from_graph(sg, device=dev))
    compare("GCN logits on a small graph, card vs CPU", gpu.cpu(), cpu, cpu.abs().max(),
            LOGIT_RTOL)

    # ------------------------------------------------------------ 5. hybrid plan
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hadj = NormAdj.from_graph(g, hybrid_k=HOT_K, device=dev)
    torch.cuda.synchronize()
    hplan = hadj.plan
    plan_s = time.perf_counter() - t0
    k = hplan.k
    d_bytes = 2 * hplan.d_full.numel() * hplan.d_full.element_size()
    log(f"[5/14] hybrid plan in {plan_s:.1f}s: K={k}, f32 mode split2 (D as a bf16 hi/lo "
        f"pair of {d_bytes / 1e6:.1f} MB), {hplan.n_resid} residual edges "
        f"({hplan.n_resid / e:.1%} of E) on the CSR kernel")
    if hplan.d_lo is None or tuple(hplan.d_full.shape) != (n, k) or k != HOT_K:
        fail(f"hybrid plan: K={k}, D {tuple(hplan.d_full.shape)}, split {hplan.d_lo is not None}")

    # ------------------------------------------------------------ 6. dual kernel
    log("[6/14] the dual kernel against its plain version (tolerance relative to "
        "|D| @ |xh| and |D|^T @ |x|):")
    pair = (hplan.d_full, hplan.d_lo)
    d32 = pair[0].float() + pair[1].float()  # the f32 D of the f32 variant
    dbf = d32.bfloat16()
    dual_errs = {"split": [], "f32": [], "bf16": [], "f32_t": []}

    def check_dual(label, variant, d, d_lo, a, b, hot_t=False, key=None, f32_ab=None):
        out, hot = dual(variant, d, d_lo, a, b, hot_t=hot_t)
        hot = hot.t() if hot_t else hot
        if not torch.equal(out, dual(variant, d, d_lo, a, b, hot_t=hot_t)[0]):
            fail(f"{label}: out differs between two launches (it is written once, "
                 "without atomics)")
        want = fd.dual_reference(variant, d, d_lo, a, b)
        scale = fd.dual_abs(variant, d, d_lo, a, b)
        errs = [compare(f"{label} out", out, want[0], scale[0], F32_RTOL),
                compare(f"{label} hot", hot, want[1], scale[1], F32_RTOL)]
        if f32_ab is not None:  # bf16 operands against the f32 ones they came from
            want = fd.dual_reference(fd.F32, d, None, *f32_ab)
            scale = fd.dual_abs(fd.F32, d, None, *f32_ab)
            compare(f"{label} out vs f32 x", out, want[0], scale[0], BF16_RTOL)
            compare(f"{label} hot vs f32 x", hot, want[1], scale[1], BF16_RTOL)
        if key is not None:
            dual_errs[key] += errs

    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        for variant, a in ((fd.SPLIT, x), (fd.BF16, x.bfloat16())):
            if not torch.equal(dual.planes(variant, a).view(torch.int16),
                               fd.operand_planes(variant, a).view(torch.int16)):
                fail(f"{fd.VARIANT_NAMES[variant]} prologue H={h}: planes differ from "
                     "operand_planes")
        log(f"  check split and bf16 prologue H={h}: planes equal to operand_planes bit for "
            "bit ok")
        forms = (("forward (x, x_hot)", x, x[hplan.hot_ids]),
                 ("backward (g_out, g_hot)", torch.randn(n, h, generator=gen, device=dev),
                  torch.randn(k, h, generator=gen, device=dev)))
        for form, a, b in forms:
            check_dual(f"split {form} H={h}", fd.SPLIT, *pair, a, b, key="split")
            check_dual(f"f32 {form} H={h}", fd.F32, d32, None, a, b, key="f32")
            check_dual(f"f32 [H, K] hot {form} H={h}", fd.F32, d32, None, a, b, hot_t=True,
                       key="f32_t")
            check_dual(f"bf16 {form} H={h}", fd.BF16, dbf, None, a.bfloat16(), b.bfloat16(),
                       key="bf16", f32_ab=(a, b))
            check_dual(f"bf16 [H, K] hot {form} H={h}", fd.BF16, dbf, None, a.bfloat16(),
                       b.bfloat16(), hot_t=True)
    rd = torch.randn(1001, 100, generator=gen, device=dev)  # N, K, H on no tile, K < 128
    ra, rb = (torch.randn(1001, 19, generator=gen, device=dev),
              torch.randn(100, 19, generator=gen, device=dev))
    check_dual("ragged 1001x100 H=19 split", fd.SPLIT, *fd.split_bf16(rd), ra, rb)
    check_dual("ragged f32", fd.F32, rd, None, ra, rb)
    check_dual("ragged f32 [H, K] hot", fd.F32, rd, None, ra, rb, hot_t=True)
    check_dual("ragged bf16", fd.BF16, rd.bfloat16(), None, ra.bfloat16(), rb.bfloat16())
    x = torch.randn(n, widths[1], generator=gen, device=dev, requires_grad=True)
    xh = torch.randn(k, widths[1], generator=gen, device=dev, requires_grad=True)
    g_out = torch.randn(n, widths[1], generator=gen, device=dev)
    g_hot = torch.randn(k, widths[1], generator=gen, device=dev)
    before = sum(dual.launches.values())
    out, hot = fd.fused_dual_split(*pair, x, xh)
    ((out * g_out).sum() + (hot * g_hot).sum()).backward()
    if sum(dual.launches.values()) != before + 2:
        fail("the dual product's autograd did not launch the kernel twice")
    want = fd.dual_reference(fd.SPLIT, *pair, g_out, g_hot)
    scale = fd.dual_abs(fd.SPLIT, *pair, g_out, g_hot)
    dual_errs["split"].append(compare(f"split gradient H={widths[1]} (x.grad = D @ g_hot)",
                                      x.grad, want[0], scale[0], F32_RTOL))
    dual_errs["split"].append(compare(f"split gradient H={widths[1]} (xh.grad = D^T @ g_out)",
                                      xh.grad, want[1], scale[1], F32_RTOL))
    del x, xh, out, hot, want, scale
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 7. hybrid SpMM
    log(f"[7/14] spmm on the hybrid plan against spmm_segment (tolerance {SPLIT2_RTOL:g} "
        f"of |A_hat| @ |x|):")
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev, requires_grad=True)
        xs = x.detach().clone().requires_grad_(True)
        ct = torch.randn(n, h, generator=gen, device=dev)
        dual_before, csr_before = dual.launches.get("split", 0), kernel.launches
        got = spmm(hadj, x)
        (got * ct).sum().backward()
        if (dual.launches["split"] - dual_before, kernel.launches - csr_before) != (2, 2):
            fail(f"hybrid SpMM H={h}: {dual.launches['split'] - dual_before} dual and "
                 f"{kernel.launches - csr_before} CSR launches, expected 2 and 2")
        want = spmm_segment(adj, xs)
        (want * ct).sum().backward()
        with torch.no_grad():
            compare(f"hybrid vs spmm_segment H={h}", got, want,
                    mag(plan.fwd, x) + adj.self_w[:, None] * x.abs(), SPLIT2_RTOL)
            compare(f"hybrid gradient vs spmm_segment H={h}", x.grad, xs.grad,
                    mag(plan.bwd, ct) + adj.self_w[:, None] * ct.abs(), SPLIT2_RTOL)
    del x, xs, got, want

    # ------------------------------------------------------------ 8. hybrid paths
    base = ["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
            "--model-n-hidden", str(hidden), "--model-dropout", "0.7", "--train-lr", "0.05",
            "--train-eval-every", "1", "--train-verbose", "0", "--train-hybrid-k", str(HOT_K)]
    hcfg = parse_config(base + ["--train-epochs", str(args.epochs)])
    check_ported(hcfg)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    hres, hsecs, hcounts = run_path(flat, hcfg, g, n_classes, counters)
    hpeak_gb = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    hist = hres["history"]
    steps = len(hist)
    evals = sum("val_f1" in rec for rec in hist) + 1
    expected = 4 * steps + 2 * evals
    losses = [rec["loss"] for rec in hist]
    path_launches = {"split": hcounts["dual"].get("split", 0)}
    log(f"[8/14] hybrid path (K={HOT_K}, split2) in {hsecs:.1f}s: {steps} train steps, "
        f"{evals} forward-only passes; dual kernel launches {hcounts['dual']}, CSR kernel "
        f"launches {hcounts['csr']} (expected {expected} each); loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; test acc {hres['accuracy']:.4f}, macro-F1 {hres['f1_macro']:.4f}; "
        f"peak memory {hpeak_gb:.2f} GB above the {mem0 / 1e9:.2f} GB held before it")
    log(f"  results row: {hres['row']}")
    if hcounts["dual"] != {"split": expected} or hcounts["csr"] != expected:
        fail(f"the hybrid path launched {hcounts}, expected {expected} split and CSR launches")
    if steps != args.epochs or not np.isfinite(losses).all() or not losses[-1] < losses[0]:
        fail(f"hybrid training: {steps} steps, losses {losses}")
    with torch.no_grad():
        logits = model(hadj, feats)
        want = model(plain_adj, feats)
    compare("GCN logits, hybrid path vs plain path (full graph)", logits, want,
            want.abs().max(), LOGIT_RTOL)
    for variant, extra in (("f32", ["--train-hybrid-fused", "on",
                                    "--train-hybrid-f32-mode", "highest"]),
                           ("bf16", ["--train-hybrid-fused", "on",
                                     "--train-pallas-dtype", "bfloat16"])):
        pcfg = parse_config(base + ["--train-epochs", "3"] + extra)
        check_ported(pcfg)
        pres, psecs, pcounts = run_path(flat, pcfg, g, n_classes, counters)
        psteps = len(pres["history"])
        pexpected = 4 * psteps + 2 * (psteps + 1)
        plosses = [rec["loss"] for rec in pres["history"]]
        log(f"  hybrid path {' '.join(extra)} in {psecs:.1f}s: {psteps} train steps, "
            f"dual kernel launches {pcounts['dual']}, CSR kernel launches {pcounts['csr']} "
            f"(expected {pexpected} each); losses {[round(v, 4) for v in plosses]}")
        if pcounts["dual"] != {variant: pexpected} or pcounts["csr"] != pexpected:
            fail(f"the {variant} hybrid path launched {pcounts}, expected {pexpected}")
        if not np.isfinite(plosses).all():
            fail(f"{variant} hybrid training: losses {plosses}")
        path_launches[variant] = pexpected
    # fused_dual_t: its only JAX caller is a probe of the dense pair; here the
    # product and its gradient at the main path's D and widths
    dual.launches = {}
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev, requires_grad=True)
        out, hot = fd.fused_dual_t(d32, x, x[hplan.hot_ids])
        (out.sum() + hot.sum()).backward()
    if dual.launches != {"f32_t": 2 * len(widths)}:
        fail(f"fused_dual_t launched {dual.launches}, expected {2 * len(widths)} f32_t")
    path_launches["f32_t"] = dual.launches["f32_t"]
    log(f"  fused_dual_t forward and backward at H={widths}: dual kernel launches "
        f"{dual.launches}")
    del x, out, hot
    torch.cuda.synchronize()

    # ------------------------------------------------------------ 9. times
    log(f"[9/14] times on {card} (CUDA events, warm, per launch):")
    by_width = []
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        xb = x.bfloat16()
        row = {"h": h}
        for pname, csr in (("fwd", plan.fwd), ("bwd", plan.bwd)):
            lib = sparse_csr(csr)
            compare(f"torch.sparse.mm {pname} H={h} vs kernel", torch.sparse.mm(lib, x),
                    kernel(csr, x), mag(csr, x), F32_RTOL)
            n_bytes, flops, bound, bound_by = spmm_work(csr, h, 4)
            row[pname] = {
                "ms": time_ms(lambda: kernel(csr, x), 50),
                "bf16_ms": time_ms(lambda: kernel(csr, xb), 50),
                "plain_ms": time_ms(lambda: plain(csr, x), 5, warmup=1),
                "library_ms": time_ms(lambda: torch.sparse.mm(lib, x), 20),
                "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes, "flops": flops,
                "bf16_bound_ms": spmm_work(csr, h, 2)[2],
            }
            r = row[pname]
            log(f"  spmm_csr {pname} H={h}: kernel {r['ms']:.4f} ms (bf16 "
                f"{r['bf16_ms']:.4f}), bound {r['bound_ms']:.4f} ms by {bound_by} "
                f"({n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP), plain "
                f"{r['plain_ms']:.4f} ms, torch.sparse.mm {r['library_ms']:.4f} ms")
        by_width.append(row)
    # a train step: 2 launches at each width, forward and transpose plans
    per_launch = [row[p] for row in by_width for p in ("fwd", "bwd")]
    mean = lambda k: sum(r[k] for r in per_launch) / len(per_launch)
    # what limits the CSR kernel: its timing builds beside it, in turns
    csr_limits = time_spmm_builds(kernel, csr_timing, {"fwd": plan.fwd, "bwd": plan.bwd},
                                  widths, gen)
    for row in csr_limits:
        log(f"  spmm_csr {row['plan']} H={row['h']}, timing builds (ms, in turns): " + "; ".join(
            f"{name} {[round(v, 4) for v in vals]}" for name, vals in row.items()
            if name not in ("h", "plan")))

    # the dual kernel per launch at the main path's shape (x_hot = x[hot] and
    # the backward's (g_out, g_hot) have the same shapes), each variant
    # beside its plain version and the two torch.mm of the JAX non-fused
    # route (f32 with TF32 off; bf16 for the bf16 variant); the split and
    # bf16 variants' times include their prologue, also timed alone
    operands = {fd.SPLIT: pair, fd.F32: (d32, None), fd.BF16: (dbf, None)}
    cast = lambda variant, *ts: tuple(t.bfloat16() if variant == fd.BF16 else t for t in ts)
    dual_rows = {key: [] for key in ("split", "f32", "f32_t", "bf16")}
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        xh = x[hplan.hot_ids]
        for key, variant, hot_t in (("split", fd.SPLIT, False), ("f32", fd.F32, False),
                                    ("f32_t", fd.F32, True), ("bf16", fd.BF16, False)):
            d, d_lo = operands[variant]
            a, b = cast(variant, x, xh)
            lib_d = dbf if variant == fd.BF16 else d32
            n_bytes, flops, bound, bound_by = dual_work(variant, n, k, h)
            r = {
                "h": h,
                "ms": time_ms(lambda: dual(variant, d, d_lo, a, b, hot_t=hot_t), 20),
                "plain_ms": time_ms(lambda: fd.dual_reference(variant, d, d_lo, a, b), 3,
                                    warmup=1),
                "library_ms": time_ms(lambda: (torch.mm(lib_d, b), torch.mm(lib_d.t(), a)),
                                      20),
                "bound_ms": bound, "bound_by": bound_by, "bytes": n_bytes, "flops": flops,
            }
            if variant != fd.F32:
                r["prologue_ms"] = time_ms(
                    lambda: (dual.planes(variant, a), dual.planes(variant, b.contiguous())), 20)
            dual_rows[key].append(r)
            log(f"  fused_dual {key} N={n} K={k} H={h}: kernel {r['ms']:.4f} ms"
                + (f" (prologue {r['prologue_ms']:.4f})" if "prologue_ms" in r else "")
                + f", bound {bound:.4f} ms by {bound_by} ({n_bytes / 1e6:.1f} MB, "
                f"{flops / 1e9:.1f} GFLOP), plain {r['plain_ms']:.4f} ms, two torch.mm "
                f"{r['library_ms']:.4f} ms")
    # the hot side's reduction into [K, H] hot (the bulk reduction for split
    # and bf16, float4 atomics for f32): each variant with it ("with_ms"),
    # without it ("without_ms": the hot product is still computed) and, for
    # split and bf16, with float4 atomics in its place ("float4_ms", the
    # FD_HOT_ATOMICS build), in turns
    hot_reduction = {key: [] for key in ("split", "bf16", "f32")}
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        xh = x[hplan.hot_ids].contiguous()
        out = torch.empty(n, h, device=dev)
        hot = torch.zeros(k, h, device=dev)
        for key, variant in (("split", fd.SPLIT), ("bf16", fd.BF16), ("f32", fd.F32)):
            a, b = cast(variant, x, xh)
            turns = ["with_ms", "without_ms"] + (["float4_ms"] if variant != fd.F32 else [])
            row = {"h": h, **{turn: [] for turn in turns}}
            for turn in turns + turns[::-1]:
                lib = hot_float4 if turn == "float4_ms" else dual
                row[turn].append(time_ms(lambda: lib.launch_raw(
                    variant, *operands[variant], a, b, out,
                    None if turn == "without_ms" else hot), 20))
            hot_reduction[key].append(row)
            log(f"  {key} kernel H={h}, the hot side's reduction (ms, in turns): with it "
                f"{row['with_ms']}, without it {row['without_ms']}"
                + (f", float4 atomics in its place {row['float4_ms']}"
                   if "float4_ms" in row else ""))
    # what limits the f32 and split variants: their timing builds beside
    # them, in turns
    limits = {"f32": [], "split": []}
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        xh = x[hplan.hot_ids].contiguous()
        out = torch.empty(n, h, device=dev)
        hot = torch.zeros(k, h, device=dev)
        for key, variant, builds in (("f32", fd.F32, {"three passes": dual, **f32_timing}),
                                     ("split", fd.SPLIT, {"three passes": dual,
                                                          "1 pass": split_1pass})):
            row = {"h": h}
            for name in list(builds) + list(builds)[::-1]:
                for atom in (True, False):
                    row.setdefault(name + ("" if atom else ", no atomics"), []).append(
                        time_ms(lambda: builds[name].launch_raw(
                            variant, *operands[variant], x, xh, out, hot if atom else None),
                            20))
            limits[key].append(row)
            log(f"  {key} kernel H={h}, timing builds (ms, in turns): " + "; ".join(
                f"{name} {v}" for name, v in row.items() if name != "h"))
    # the hybrid SpMM per application (forward), against the CSR kernel's
    # whole-graph SpMM at the same width
    hybrid_app = []
    for h, row in zip(widths, by_width):
        x = torch.randn(n, h, generator=gen, device=dev)
        ms = time_ms(lambda: spmm_hybrid(hplan, x), 20)
        hybrid_app.append({"h": h, "spmm_hybrid_ms": ms, "spmm_csr_ms": row["fwd"]["ms"]})
        log(f"  spmm_hybrid H={h}: {ms:.4f} ms per application (dual kernel + hot "
            f"correction + residual CSR kernel); spmm_csr on the whole graph "
            f"{row['fwd']['ms']:.4f} ms")
    # the split kernel alone at other K on random D pairs of the graph's N,
    # with the residual edge count this graph would leave at each K
    deg = np.bincount(np.asarray(g.edge_src), minlength=n)
    rank = np.empty(n, np.int64)
    rank[np.argsort(-deg, kind="stable")] = np.arange(n)
    r_src, r_dst = rank[np.asarray(g.edge_src)], rank[np.asarray(g.edge_dst)]
    k_sweep = []
    del out, hot
    for ks in K_SWEEP:
        sd = torch.randn(n, ks, generator=gen, device=dev)
        spair = fd.split_bf16(sd)
        del sd
        x = torch.randn(n, widths[0], generator=gen, device=dev)
        xh = torch.randn(ks, widths[0], generator=gen, device=dev)
        n_bytes, flops, bound, bound_by = dual_work(fd.SPLIT, n, ks, widths[0])
        ms = time_ms(lambda: dual(fd.SPLIT, *spair, x, xh), 20)
        resid = int(np.sum((r_src >= ks) & (r_dst >= ks)))
        k_sweep.append({"k": ks, "h": widths[0], "ms": ms, "bound_ms": bound,
                        "bound_by": bound_by, "resid_edges": resid})
        log(f"  K sweep: split kernel K={ks} H={widths[0]}: {ms:.4f} ms, bound {bound:.4f} "
            f"ms by {bound_by}; this graph leaves {resid} residual edges "
            f"({resid / e:.1%} of E) at this K")
        del spair
    torch.cuda.synchronize()

    step_ms = {}
    for path, kw in (("kernel", dict(use_pallas=True)), ("hybrid", dict(hybrid_k=HOT_K)),
                     ("plain", dict(use_pallas=False))):
        tmodel = make_model(cfg.model, g.in_dim, n_classes,
                            generator=torch.Generator().manual_seed(3))
        trainer = Trainer(tmodel, lr=0.05, device=dev, **kw)
        tadj, tfeats = trainer.prepare(g)
        y = torch.as_tensor(g.y, dtype=torch.int64, device=dev)
        mask = torch.as_tensor(g.train_mask, device=dev)
        step = lambda: trainer._train_step(tadj, tfeats, y, mask)
        step_ms[path] = host_step_ms(step)
        if path != "plain" and args.profile:
            profile_step(args.profile, card, f"{path} path, N={n} E={e}", path, step,
                         step_ms[path])
    log(f"  train step (forward, loss, backward, Adam): CSR kernel path "
        f"{step_ms['kernel']:.3f} ms, hybrid path (K={HOT_K}) {step_ms['hybrid']:.3f} ms, "
        f"plain path {step_ms['plain']:.3f} ms (host clock, 20 steps)")

    # ------------------------------------------------------------ 10. models, hierarchies
    paths, widths_run, width_errs, width_times, (cat1, cat2) = models_and_hierarchies(
        args, card, cfg, g, n_classes, hidden, plan, counters, gen, dev)
    f32_errs += width_errs

    # ------------------------------------------------------------ 11. operator options
    csr_ms_by_width = {r["h"]: r["ms"] for r in width_times}
    csr_ms_by_width.update((row["h"], row["fwd"]["ms"]) for row in by_width)
    options, option_errs, option_rows = operator_options(
        args, card, g, n_classes, hidden, adj, counters, gen, dev, cat1, cat2,
        csr_ms_by_width)
    f32_errs += option_errs

    # ------------------------------------------------------------ 12. MLP, loaders, options
    last, last_errs, mlp_rows = mlp_and_last_options(args, card, g, n_classes, hidden,
                                                     counters, gen, dev, cat1, cat2)
    f32_errs += last_errs

    # ------------------------------------------------------------ 13. counting, mini-batching
    slice10, slice10_errs, subgraph_rows = counting_and_minibatching(
        args, card, cfg, g, n_classes, adj, counters, gen, dev)
    f32_errs += slice10_errs

    # ------------------------------------------------------------ 14. tooling, drivers
    log("[14/14] tooling and drivers:")
    probe_out, pr = probe_against_spec(card, dev)
    slice11 = tooling_and_drivers(args, card, g, dev, pr)
    slice11["probe"] = probe_out

    def dual_entry(key, replaces, path):
        rows = dual_rows[key]
        avg = lambda name: sum(r[name] for r in rows) / len(rows)
        return {
            "name": f"fused_dual_{key}",
            "route": "cuda",
            "source": "pytextgcn_tpu_torch/csrc/fused_dual.cu",
            "replaces": replaces,
            "launches": path_launches[key],
            "max_abs_err": max(dual_errs[key]),
            "ms": avg("ms"),
            "plain_ms": avg("plain_ms"),
            "bound_ms": avg("bound_ms"),
            "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
            else "operations",
            "library_ms": avg("library_ms"),
            "ms_averages": f"per launch at N={n}, K={k}, H={widths[0]} and H={widths[1]}",
            "path": path,
            "by_width": rows,
        }

    kernels = [{
        "name": "spmm_csr",
        "route": "cuda",
        "source": "pytextgcn_tpu_torch/csrc/spmm_csr.cu",
        "replaces": "pytextgcn_tpu/ops/spmm_pallas.py:274",
        "launches": launches,
        "max_abs_err": max(f32_errs),
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in per_launch)
        else "operations",
        "library_ms": mean("library_ms"),
        "bf16_max_abs_err": max(bf16_errs),
        "ms_averages": "per launch over the main path's mix: fwd and transpose "
                       f"plans at H={widths[0]} and H={widths[1]}",
        "by_width": by_width,
        "graph": {"n_nodes": n, "n_edges": e},
        "launches_hybrid_path": hcounts["csr"],
        "timing_builds": csr_limits,
        "step_ms": step_ms,
        "peak_memory_gb": peak_gb,
        "models_hierarchies": paths,
        "widths_run_models_hierarchies": widths_run,
        "by_width_models_hierarchies": width_times,
        "restricted_plans": option_rows["restricted"],
        "ensemble_width": option_rows["h600"],
        "operator_options": options,
        "mlp_plans": mlp_rows,
        "mlp_and_last_options": last,
        "subgraph_plans": subgraph_rows,
        "counting_and_minibatching": slice10,
        "tooling_and_drivers": slice11,
    },
        {**dual_entry("split", "pytextgcn_tpu/ops/fused_dual.py:185",
                      f"flat.run --train-hybrid-k {HOT_K} (f32 split2, the default), "
                      f"{args.epochs} epochs"),
         "hot_reduction": hot_reduction["split"], "timing_builds": limits["split"],
         "spmm_hybrid": hybrid_app, "k_sweep": k_sweep,
         "hybrid_plan": {"k": k, "n_resid": hplan.n_resid, "d_bytes": d_bytes,
                         "build_s": plan_s},
         "hybrid_path_peak_memory_gb": hpeak_gb},
        {**dual_entry("f32", "pytextgcn_tpu/ops/fused_dual.py:53",
                      f"flat.run --train-hybrid-k {HOT_K} --train-hybrid-fused on "
                      "--train-hybrid-f32-mode highest, 3 epochs"),
         "hot_reduction": hot_reduction["f32"], "timing_builds": limits["f32"]},
        {**dual_entry("bf16", "pytextgcn_tpu/ops/fused_dual.py:53",
                      f"flat.run --train-hybrid-k {HOT_K} --train-hybrid-fused on "
                      "--train-pallas-dtype bfloat16, 3 epochs"),
         "hot_reduction": hot_reduction["bf16"]},
        dual_entry("f32_t", "pytextgcn_tpu/ops/fused_dual.py:159",
                   "fused_dual_t forward and backward on the main path's D at both widths"),
    ]
    log(f"total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
