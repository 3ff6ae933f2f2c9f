"""The port stands alone: no module of pytextgcn_tpu_torch, and not
chip_smoke.py, imports jax or anything of the JAX package, nor sklearn,
pandas or optax, which the GPU machine does not have."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
FILES = sorted((ROOT / "pytextgcn_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "pytextgcn_tpu", "sklearn", "pandas", "optax")


def _imported_modules(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value
        elif (isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imported_modules(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"


# the EGCN/JK, checkpoint and hierarchy modules, the trainer's operator
# options (the masked head's restricted operator, the plan cache), the MLP
# baselines and the CSV loaders, the bench, profiling, the probe and the
# last drivers
MODELS_AND_HIERARCHIES = ["models/jk.py", "train/checkpoint.py", "hierarchy/__init__.py",
           "hierarchy/perlevel.py", "hierarchy/perlabel.py", "experiments/perlevel.py",
           "experiments/perlabel.py", "experiments/protocol.py", "ops/restricted.py",
           "ops/plan_cache.py", "models/mlp.py", "baselines/mlp_pipeline.py",
           "experiments/mlp.py", "data/loaders.py", "bench.py", "train/profiling.py",
           "ops/probe.py", "experiments/hyperopt.py", "experiments/benchmark_graph.py",
           "build/native_bridge.py"]


def test_every_port_module_is_checked():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py") in FILES
    for name in MODELS_AND_HIERARCHIES:
        assert ROOT / "pytextgcn_tpu_torch" / name in FILES, name
