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
# baselines and the CSV loaders, the bench, profiling, the probe, the
# last experiment scripts and the graph partitions over ranks (parallel/)
MODELS_AND_HIERARCHIES = ["models/jk.py", "train/checkpoint.py", "hierarchy/__init__.py",
           "hierarchy/perlevel.py", "hierarchy/perlabel.py", "experiments/perlevel.py",
           "experiments/perlabel.py", "experiments/protocol.py", "ops/restricted.py",
           "ops/plan_cache.py", "models/mlp.py", "baselines/mlp_pipeline.py",
           "experiments/mlp.py", "data/loaders.py", "bench.py", "train/profiling.py",
           "ops/probe.py", "experiments/hyperopt.py", "experiments/benchmark_graph.py",
           "build/native_bridge.py", "parallel/__init__.py", "parallel/multihost.py",
           "parallel/sharded.py", "parallel/halo.py"]


def test_every_port_module_is_checked():
    assert len(FILES) > 20 and (ROOT / "chip_smoke.py") in FILES
    for name in MODELS_AND_HIERARCHIES:
        assert ROOT / "pytextgcn_tpu_torch" / name in FILES, name


# the layers: the operators (ops/) never reach the partitions over ranks
# (parallel/, which imports ops); a Trainer's operator, its key and its
# features are written by the trainer alone (Trainer.prepare and
# Trainer.adopt, which the ensemble and share_adjacency go through)
PORT = ROOT / "pytextgcn_tpu_torch"
TRAINER_FIELDS = ("_adj", "_adj_key", "_feats")


def _imports_parallel(tree, path):
    package = path.relative_to(ROOT).with_suffix("").parts[:-1]
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = list(package[:len(package) - node.level + 1]) if node.level else []
            module = base + (node.module.split(".") if node.module else [])
            names = [".".join(module + [alias.name]) for alias in node.names]
        else:
            continue
        if any(n.startswith("pytextgcn_tpu_torch.parallel") for n in names):
            return True
    return False


def _writes_trainer_fields(tree):
    for node in ast.walk(tree):
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, (ast.AugAssign, ast.AnnAssign))
                   else [])
        for target in targets:
            for t in ast.walk(target):
                if isinstance(t, ast.Attribute) and t.attr in TRAINER_FIELDS:
                    return t.attr
    return None


LAYER_CASES = ([("ops-imports-no-parallel", p) for p in sorted((PORT / "ops").rglob("*.py"))]
               + [("only-the-trainer-writes-its-operator", p) for p in FILES
                  if p != PORT / "train" / "trainer.py"])


@pytest.mark.parametrize("rule,path", LAYER_CASES,
                         ids=[f"{rule}:{p.relative_to(ROOT)}" for rule, p in LAYER_CASES])
def test_layering(rule, path):
    tree = ast.parse(path.read_text(), filename=str(path))
    if rule == "ops-imports-no-parallel":
        assert not _imports_parallel(tree, path), f"{path.relative_to(ROOT)} imports parallel"
    else:
        field = _writes_trainer_fields(tree)
        assert field is None, f"{path.relative_to(ROOT)} assigns a Trainer's {field}"


def test_the_layering_rules_see_what_they_forbid():
    """Each rule, on code that breaks it: a relative and an absolute import of
    parallel from ops/, and the writes the ensemble once made."""
    ops_file = PORT / "ops" / "spmm.py"
    for src in ("from ..parallel import HaloAdj", "from .. import parallel",
                "import pytextgcn_tpu_torch.parallel.halo",
                "def f():\n    from ..parallel.halo import spmm_halo"):
        assert _imports_parallel(ast.parse(src), ops_file), src
    assert not _imports_parallel(ast.parse("from .hybrid import segment_sum"), ops_file)
    assert _writes_trainer_fields(ast.parse("t._adj, t._adj_key, t._feats = a, k, f")) == "_adj"
    assert _writes_trainer_fields(ast.parse("t._feats = f")) == "_feats"
    assert _writes_trainer_fields(ast.parse("adj = t._adj")) is None
