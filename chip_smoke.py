#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``pytextgcn_tpu_torch``) on one GPU.

Run from the root of a checkout on a machine with an NVIDIA H100:

    python3 chip_smoke.py                      # the full check, ~2 min
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
   path's train step time and peak memory are printed.

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

# H100 SXM data-sheet peaks: HBM3 bandwidth, f32 outside the tensor cores,
# dense bf16 and dense TF32 on the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12
PEAK_TF32_FLOP_PER_S = 495e12
HOT_K = 4096  # the hybrid's hot-set size on the main path
MODEL_EPOCHS = 5  # epochs of each phase-10 path (a level or member each)
K_SWEEP = (1024, 2048, 4096)

# Tolerances are relative to the sum of the terms' magnitudes (|A| @ |x|,
# spmm_cuda.spmm_csr_abs), which bounds what summing in another order moves
F32_RTOL, ATOL = 1e-5, 1e-6  # f32 sums in another order
BF16_RTOL = 2.0**-8  # x rounded to bf16 (relative error <= 2^-9) against f32 x
LOGIT_RTOL = 1e-4  # logits two sums deep, relative to the largest logit
SPLIT2_RTOL = 3e-5  # the split2 class against f32 (tests/test_spmm_hybrid.py:73-79)


def log(msg: str) -> None:
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


def device_busy_us(trace_path: str) -> float:
    """Microseconds in which the device ran something, from a chrome trace:
    the union of its kernel, memcpy and memset spans."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events
                   if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for s, t in spans:
        if t > end:
            busy += t - max(s, end)
            end = t
    return busy


def profile_step(out_dir: str, card: str, title: str, tag: str, step, step_ms: float) -> float:
    """torch.profiler over 5 calls of ``step``: writes its table and chrome
    trace under ``out_dir`` and returns the device's busy ms a step (the
    union of its kernel, memcpy and memset spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOP_PER_S * 1e3
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
    peak = PEAK_TF32_FLOP_PER_S if variant == fd.F32 else PEAK_BF16_FLOP_PER_S
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return n_bytes, flops, max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


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
    log(f"[10/10] models and hierarchies on the CSR kernel ({MODEL_EPOCHS} epochs a "
        "level or member):")
    _, (cat1, cat2), _, _ = common.load_corpus(cfg, levels=["Cat1", "Cat2"])
    if not np.array_equal(cat2, np.asarray(g.y)[g.n_vocab:]):
        fail("the corpus's Cat2 labels differ from phase 2's graph")
    test_docs = np.asarray(g.test_mask)[g.n_vocab:]
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
        routed = sum(bool(((cat1 == c) & test_docs).any()) for c in range(6))
        record("gcn per-label", res["trainers"], secs, counts,
               sum(passes(h) for h in res["histories"]) + 2 * routed, peak,
               f"6 members of {sizes} classes, losses {losses}, test acc "
               f"{res['accuracy']:.4f}, macro-F1 {res['f1_macro']:.4f}",
               res["trainers"][int(np.argmax(sizes))])  # the member with the most classes
        back, secs, counts, peak = drive(perlabel.run, pcfg, g, cat1, cat2, eval_only=True)
        if not np.array_equal(back["predictions"], res["predictions"]):
            fail("per-label --eval-only: predictions differ from the trained ensemble's")
        record("gcn per-label --eval-only", back["trainers"], secs, counts, 2 * routed, peak,
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
        row = {"h": h, "ms": time_ms(lambda: kernel(plan.fwd, x), 20),
               "plain_ms": time_ms(lambda: plain(plan.fwd, x), 3, warmup=1),
               "bound_ms": bound, "bound_by": bound_by}
        by_width.append(row)
        log(f"  spmm_csr fwd H={h}: kernel {row['ms']:.4f} ms, bound {bound:.4f} ms by "
            f"{bound_by}, plain {row['plain_ms']:.4f} ms")
    torch.cuda.synchronize()
    return paths, sorted(widths_run), errs, by_width


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--profile", default=None,
                    help="directory for torch.profiler tables of 5 train steps on the CSR "
                         "kernel path, on the hybrid path and on each phase-10 path")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(ROOT, "pytextgcn_tpu_torch")):
        fail("pytextgcn_tpu_torch/ is not beside this script: run it from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this check needs a CUDA device")
    sys.path.insert(0, ROOT)
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
    log(f"[1/10] built the two CUDA kernels (and {len(csr_timing)} timing builds of the CSR "
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
    log(f"[2/10] graph in {time.perf_counter() - t0:.1f}s: N={n} E={e} "
        f"(vocab {g.n_vocab}, docs {g.n_docs}), {n_classes} classes")
    widths = (hidden, n_classes)

    # ------------------------------------------------------------ 3. check
    t0 = time.perf_counter()
    adj = NormAdj.from_graph(g, use_pallas=True, device=dev)
    plan = adj.plan
    log(f"[3/10] plan in {time.perf_counter() - t0:.1f}s: {plan.fwd.seg_row.shape[0]} "
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
    log(f"[4/10] main path in {main_s:.1f}s: {steps} train steps, {evals} forward-only "
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
    log(f"[5/10] hybrid plan in {plan_s:.1f}s: K={k}, f32 mode split2 (D as a bf16 hi/lo "
        f"pair of {d_bytes / 1e6:.1f} MB), {hplan.n_resid} residual edges "
        f"({hplan.n_resid / e:.1%} of E) on the CSR kernel")
    if hplan.d_lo is None or tuple(hplan.d_full.shape) != (n, k) or k != HOT_K:
        fail(f"hybrid plan: K={k}, D {tuple(hplan.d_full.shape)}, split {hplan.d_lo is not None}")

    # ------------------------------------------------------------ 6. dual kernel
    log("[6/10] the dual kernel against its plain version (tolerance relative to "
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
    log(f"[7/10] spmm on the hybrid plan against spmm_segment (tolerance {SPLIT2_RTOL:g} "
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
    log(f"[8/10] hybrid path (K={HOT_K}, split2) in {hsecs:.1f}s: {steps} train steps, "
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
    log(f"[9/10] times on {card} (CUDA events, warm, per launch):")
    by_width = []
    for h in widths:
        x = torch.randn(n, h, generator=gen, device=dev)
        xb = x.bfloat16()
        row = {"h": h}
        for pname, csr in (("fwd", plan.fwd), ("bwd", plan.bwd)):
            lib = torch.sparse_csr_tensor(csr.row_ptr, csr.col.contiguous(),
                                          csr.val.contiguous(),
                                          size=(csr.n_rows, csr.n_cols),
                                          check_invariants=False)
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
    paths, widths_run, width_errs, width_times = models_and_hierarchies(
        args, card, cfg, g, n_classes, hidden, plan, counters, gen, dev)
    f32_errs += width_errs

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
