"""The harness finds configurations, traffic, limits and metrics by name
from files, and BENCHMARK.json keeps to the contract's form."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness

ROOT = harness.ROOT
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_spec_keys_and_names():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names += [m["name"] for m in metrics] + [w["traffic"] for w in SPEC["workloads"]]
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert "setup_s" in {m["name"] for m in SPEC["end_to_end"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
    for m in SPEC["per_layer"]:
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(workload):
    cell = harness.load_cell(workload)
    assert cell.config["model"]["kind"] in ("gcn", "egcn")
    assert set(cell.limits) <= set(harness.check.NUMBERS)
    for m in cell.end_to_end + cell.per_layer:
        assert callable(harness.metric_reader(m["name"]))


def test_a_cell_and_a_metric_are_added_as_files_only(tmp_path):
    """A new traffic mix, cell, limits and per-layer metric (a name with a
    dot) are found without an edit to any file the benchmark has."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "benchmark"), root / "benchmark")
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "textgcn-amazon.short", "config": "textgcn-amazon",
                              "traffic": "short", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "epochs_seen.test", "unit": "epochs", "better": "higher",
                              "source": "program_counter", "layer": "trainer and model",
                              "moves": "epoch_ms", "workloads": ["textgcn-amazon.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic", "train.json")))
    (root / "benchmark" / "traffic" / "short.json").write_text(
        json.dumps(dict(traffic, epochs_per_fit=50)))
    shutil.copy(os.path.join(ROOT, "benchmark", "limits", "textgcn-amazon.train.json"),
                root / "benchmark" / "limits" / "textgcn-amazon.short.json")
    (root / "benchmark" / "metrics" / "epochs_seen.test.py").write_text(
        "def read(run):\n    return len(run.epoch_s)\n")
    cell = harness.load_cell("textgcn-amazon.short", root=str(root))
    assert cell.traffic["epochs_per_fit"] == 50
    assert [m["name"] for m in cell.per_layer][-1] == "epochs_seen.test"
    assert harness.load_cell("textgcn-amazon.train", root=str(root)).per_layer[-1]["name"] \
        != "epochs_seen.test"
    read = harness.metric_reader("epochs_seen.test", root=str(root))

    class R:
        epoch_s = [0.1, 0.2]

    assert read(R) == 2


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_every_setting_of_a_configuration_reaches_the_program(config):
    """``trainer`` is passed whole to the port's ``Trainer``, ``model`` (but
    ``kind``) to its ``ModelConfig`` and ``graph`` to ``Text2Graph``: each key
    is one of theirs, so no setting is read by nothing."""
    import dataclasses as dc
    import inspect

    from pytextgcn_tpu_torch.build.text2graph import Text2Graph
    from pytextgcn_tpu_torch.config import ModelConfig
    from pytextgcn_tpu_torch.train.trainer import Trainer

    cfg = json.load(open(os.path.join(ROOT, "benchmark", "configs", f"{config}.json")))
    assert set(cfg["trainer"]) <= set(inspect.signature(Trainer).parameters) - {
        "model", "seed", "device"}
    assert set(cfg["model"]) - {"kind"} <= {f.name for f in dc.fields(ModelConfig)}
    assert set(cfg["graph"]) <= set(inspect.signature(Text2Graph).parameters) - {
        "verbose", "n_jobs"}
    assert os.path.exists(os.path.join(ROOT, "benchmark", "models", f"{cfg['model']['kind']}.py"))


def test_every_traffic_mix_names_a_loop():
    for w in SPEC["workloads"]:
        traffic = harness.load_cell(w["name"]).traffic
        assert callable(harness.load_loop(traffic["loop"]).run)


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such.cell")
