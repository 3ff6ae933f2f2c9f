"""The command's refusals, and the frozen copies against the program's."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import corpus, harness

RUN = os.path.join(harness.ROOT, "benchmark", "run.py")
ARGS = ["--workload", "textgcn-amazon.train", "--seed", "2147483659", "--seconds", "1",
        "--trace", "0"]


def test_without_a_card_it_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    res = subprocess.run([sys.executable, RUN] + ARGS, capture_output=True, text=True,
                         cwd=harness.ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "CUDA device" in res.stderr


def test_with_only_its_own_files_it_exits_nonzero_and_prints_no_result(tmp_path):
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "benchmark/run.py"] + ARGS, capture_output=True,
                         text=True, cwd=tmp_path, env=env)
    assert res.returncode != 0 and res.stdout == ""


def test_the_corpus_copy_equals_the_programs_generator():
    from pytextgcn_tpu_torch.data.synthetic import PROTOCOL_CFGS, protocol_corpus

    cfg = harness.load_cell("textgcn-amazon.train").config["data"]["corpus"]
    assert {k: list(v) if isinstance(v, tuple) else v
            for k, v in PROTOCOL_CFGS["amazon"].items()} == cfg
    for seed in (0, 2 ** 31 + 3):
        ours = corpus.protocol_corpus(cfg, 300, seed)
        theirs = protocol_corpus("amazon", n_docs=300, seed=seed)
        assert ours[0] == theirs[0] and ours[2:] == theirs[2:]
        assert all(np.array_equal(a, b) for a, b in zip(ours[1], theirs[1]))


def test_the_split_is_the_flat_drivers():
    from pytextgcn_tpu_torch.experiments.common import split_blocks

    a = corpus.split_blocks(800, 0, 1000, np.random.default_rng(7), 0.1)
    b = split_blocks(800, 0, 1000, np.random.default_rng(7), 0.1)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
