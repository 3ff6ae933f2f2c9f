"""A whole run of each cell, the card's check skipped, on a small corpus on
the CPU: ``correct`` is true, and false with the timed path broken
underneath in each way a one-card training cell can be broken, in the whole
run or in the timed window alone."""

import contextlib
import dataclasses
import time
from unittest import mock

import numpy as np
import pytest
import torch

import pytextgcn_tpu_torch.build.text2graph as t2g
import pytextgcn_tpu_torch.ops.spmm_cuda as spmm_cuda
from benchmark import calibrate, harness
from benchmark.loops import fit as fit_loop

CELLS = ["textgcn-amazon.train", "egcn-amazon.train"]
WINDOW_CHECKS = ("step_loss_gap", "step_grad_gap", "step_unmoved")


def small(cell):
    """The cell with fits of 20 epochs, so that the window's first fit (which
    holds the compared step) ends within a short test window."""
    return dataclasses.replace(cell, traffic=dict(cell.traffic, epochs_per_fit=20))


def run(cell_name, seed=2 ** 31 + 5):
    cell = small(harness.load_cell(cell_name))
    return cell, harness.run_cell(cell, seed, 0.2, False, torch.device("cpu"),
                                  time.perf_counter(), n_docs=400, log=lambda *a, **k: None)


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    spec, res = run(cell)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {m["name"] for m in spec.end_to_end}


def frozen_step():
    """The optimizer's step leaves the state unchanged."""
    return mock.patch.object(torch.optim.Adam, "step", lambda self, closure=None: None)


def half_batch():
    """Half of the train rows left out of the loss, the mean over the rest."""
    return calibrate.half_batch()


def altered_edge():
    """One edge weight of the built graph doubled where it is produced."""
    orig = t2g.Text2Graph.fit_transform

    def fit_transform(self, *a, **k):
        g = orig(self, *a, **k)
        w = np.array(g.edge_w, copy=True)
        w[len(w) // 3] *= 2.0
        return dataclasses.replace(g, edge_w=w)

    return mock.patch.object(t2g.Text2Graph, "fit_transform", fit_transform)


def altered_product():
    """One entry of every SpMM product altered where the kernel (here its
    plain version) produces it."""
    orig = spmm_cuda.spmm_csr

    def spmm_csr(csr, x):
        out = orig(csr, x)
        out[0, 0] += 1e-2
        return out

    return mock.patch.object(spmm_cuda, "spmm_csr", spmm_csr)


@contextlib.contextmanager
def in_window(fault):
    """``fault`` from the start of the timed window on: the set-up's epochs
    run sound."""
    orig = fit_loop.window
    stack = contextlib.ExitStack()

    def window(*a, **k):
        stack.enter_context(fault())
        return orig(*a, **k)

    with stack, mock.patch.object(fit_loop, "window", window):
        yield


@pytest.mark.parametrize("fault", [frozen_step, half_batch, altered_edge, altered_product])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_run_is_not_correct(cell, fault):
    with fault():
        _, res = run(cell)
    assert not res["correct"]
    assert not all(c["value"] <= c["limit"] for c in res["checks"].values())


@pytest.mark.parametrize("fault", [frozen_step, half_batch, altered_product])
@pytest.mark.parametrize("cell", CELLS)
def test_a_run_broken_in_the_window_alone_is_not_correct(cell, fault):
    with in_window(fault):
        _, res = run(cell)
    assert not res["correct"]
    failed = {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}
    assert failed and failed <= set(WINDOW_CHECKS)
