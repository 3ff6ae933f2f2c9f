"""The readings the limits of ``limits/<cell>.json`` are set from, at the
cell's own size, on the card (the benchmark's runs do not run this).

For each seed: the program's numbers against the reference (the lower
readings, over a dozen seeds or more), from the loop's set-up epochs and the
window's compared step, reached by a first ``fit`` of ``check_within + 1``
epochs (the window's arithmetic, cut to the epochs compared). On the first
``--control-seeds``: the control, the reference computed in TF32 put in the
program's place, and two faults planted in the program: half of the train
rows left out of the step's loss (the mean over the rest), and one edge
weight of the built graph doubled (an answer altered where it is produced).
A step that leaves the state unchanged reads 1 on ``update_gap`` by
construction and is not run.

    python3 benchmark/calibrate.py --workload textgcn-amazon.train \\
        --seeds 101 102 ... --control-seeds 3 --out cal.jsonl

Each reading is a JSON line ``{"seed", "kind", <number>: value, ...}``.
"""

import argparse
import contextlib
import dataclasses
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark import harness, weights  # noqa: E402


@contextlib.contextmanager
def half_batch():
    """The train step's loss over every other train row only."""
    import pytextgcn_tpu_torch.train.trainer as tr

    orig = tr.masked_cross_entropy

    def halved(logits, y, mask, denom=None):
        if logits.requires_grad:
            rows = torch.nonzero(mask).flatten()
            mask = mask.clone()
            mask[rows[::2]] = False
        return orig(logits, y, mask, denom)

    tr.masked_cross_entropy = halved
    try:
        yield
    finally:
        tr.masked_cross_entropy = orig


def altered(g, seed: int):
    """``g`` with one edge weight, drawn from the seed, doubled."""
    w = np.array(g.edge_w, copy=True)
    k = int(np.random.default_rng(seed).integers(len(w)))
    w[k] *= 2.0
    return dataclasses.replace(g, edge_w=w)


def program_run(cell, loop, g, n_classes, seed, device):
    """The program's set-up and compared step, and its graph."""
    out = loop.run(cell, g, n_classes, seed, 0.0, [], device)
    prog_graph = harness.program_graph(g, out["adj"])
    compared = out["compared"]
    del out
    torch.cuda.empty_cache()
    return prog_graph, compared


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, default=3)
    ap.add_argument("--out", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n-docs", type=int, default=0, help="0: the configuration's size")
    args = ap.parse_args()
    device = torch.device(args.device)
    cell = harness.load_cell(args.workload)
    cell = dataclasses.replace(cell, traffic=dict(
        cell.traffic, epochs_per_fit=int(cell.traffic["check_within"]) + 1))
    loop = harness.load_loop(cell.traffic["loop"])
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "a") as out:
        def emit(seed, kind, values):
            rec = {"workload": cell.name, "seed": seed, "kind": kind, **values}
            out.write(json.dumps(rec) + "\n")
            out.flush()
            print(json.dumps(rec), flush=True)

        for i, seed in enumerate(args.seeds):
            inputs, n_classes, g, _ = harness.make_graph(cell, seed, args.n_docs)
            ref_g = harness.reference_graph(cell, inputs, device)
            params = weights.initial_params(cell.config["model"], g.n_nodes, n_classes, seed,
                                            device)

            def judged(prog_graph, compared, precision="float64"):
                ref = loop.reference(cell, ref_g, params, compared, seed, device, precision)
                return ref, harness.readings(loop, prog_graph, compared, ref_g, ref)

            prog_graph, compared = program_run(cell, loop, g, n_classes, seed, device)
            ref, values = judged(prog_graph, compared)
            emit(seed, "program", values)
            if i >= args.control_seeds:
                continue
            ctl = loop.reference(cell, ref_g, params, compared, seed, device, precision="tf32")
            ctl_graph = dict(ref_g, norm_w=ref_g["norm_w"].astype(np.float32),
                             self_w=ref_g["self_w"].astype(np.float32))
            emit(seed, "control_tf32", harness.readings(loop, ctl_graph, ctl, ref_g, ref))
            with half_batch():
                emit(seed, "fault_half_batch",
                     judged(*program_run(cell, loop, g, n_classes, seed, device))[1])
            emit(seed, "fault_altered_edge",
                 judged(*program_run(cell, loop, altered(g, seed), n_classes, seed, device))[1])


if __name__ == "__main__":
    main()
