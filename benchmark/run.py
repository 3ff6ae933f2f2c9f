"""Run one cell of the benchmark once and print its result as the last line.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits with a code other than 0, printing no result, where the card is
missing or JAX or the JAX package is loaded once the window has closed.
"""

import os
import time


def _process_age() -> float:
    """Seconds since this process started (10 ms resolution), 0 without /proc."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return 0.0


PROCESS_START = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        ap.error("--seed must be a whole number >= 0")

    import torch

    from benchmark import harness

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {args.workload} needs {cell.chips} CUDA device(s), "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                              torch.device("cuda", 0), PROCESS_START)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
