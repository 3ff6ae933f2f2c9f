"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level module names (``pytextgcn_tpu_torch`` is not
``pytextgcn_tpu``), and the reference loads nothing of the program."""

import ast
import os
import subprocess
import sys

from benchmark import harness

BENCH = os.path.join(harness.ROOT, "benchmark")


def imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(*sub):
    for d, _, files in os.walk(os.path.join(BENCH, *sub)):
        if "tests" not in os.path.relpath(d, BENCH).split(os.sep):
            yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    for path in sources():
        assert not imported_tops(path) & set(harness.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_program():
    for path in [*sources("reference"), *sources("models")]:
        assert "pytextgcn_tpu_torch" not in imported_tops(path), path
        assert not any(t.startswith("benchmark") and t != "benchmark"
                       for t in imported_tops(path))
    code = ("import sys; sys.path.insert(0, %r); import benchmark.reference.graph, "
            "benchmark.reference.train; print(sorted({m.split('.')[0] for m in sys.modules}))"
            % harness.ROOT)
    loaded = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                            check=True).stdout
    assert "'pytextgcn_tpu_torch'" not in loaded and "'jax'" not in loaded


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "pytextgcn_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_like", sys)
    assert "pytextgcn_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "pytextgcn_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "flax", sys)
    assert {"flax", "pytextgcn_tpu"} <= set(harness.forbidden_modules())


def test_a_run_loads_neither(tmp_path):
    """A whole run of a small cell on the CPU leaves no module of JAX or the
    JAX package loaded."""
    code = f"""
import dataclasses, sys, time, torch
sys.path.insert(0, {harness.ROOT!r})
from benchmark import harness
cell = harness.load_cell("egcn-amazon.train")
cell = dataclasses.replace(cell, traffic=dict(cell.traffic, epochs_per_fit=50))
harness.run_cell(cell, 5, 0.3, True, torch.device("cpu"), time.perf_counter(), n_docs=300,
                 log=lambda *a, **k: None)
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    assert out == "[]"
