"""``Trainer.fit``'s CUDA graphs (``train/graphs.py``) and its one read per
epoch.

On the CPU: where ``fit`` runs eagerly (the CPU, debug checks, a mesh,
``fit_minibatch``) it never captures, and its single read per epoch gives the
history and the log lines of one read per number, early-stopping exits
included. The benchmark's reader of the replay spans on a hand-built trace.

The tests marked ``gpu`` skip without a card. They hold a graphed ``fit``
against an all-eager one (the same trainer with a no-op gradient hook, which
keeps every step eager) bit for bit: history, parameters, Adam's state, the
dropout generator's state and the CSR kernel's launch counter. On the card
(no JAX there, so tests/conftest.py is skipped and the marker registered on
the command line):
``python -m pytest --noconftest -o "markers=gpu: needs a CUDA device"
tests/test_torch_fit_graphs.py -q``.
"""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, tracing
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.config import ModelConfig, make_model
from pytextgcn_tpu_torch.data import synthetic_corpus
from pytextgcn_tpu_torch.ops import spmm_cuda
from pytextgcn_tpu_torch.parallel.sharded import Mesh
from pytextgcn_tpu_torch.train import Trainer, profiling
from pytextgcn_tpu_torch.train.trainer import EPOCH_READ

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def graph():
    docs, labels = synthetic_corpus(n_docs=120, n_classes=4, seed=11)
    rng = np.random.default_rng(1)
    test_idx = rng.choice(120, 24, replace=False)
    val_idx = np.setdiff1d(rng.choice(120, 20, replace=False), test_idx)
    return Text2Graph(min_df=1, window_size=5).fit_transform(
        docs, labels, test_idx=test_idx, val_idx=val_idx)


def _model(g, kind="gcn", dropout=0.5):
    cfg = ModelConfig(model=kind, n_hidden=16, dropout=dropout, embedding_dim=64)
    return make_model(cfg, g.in_dim, 4, torch.Generator().manual_seed(7))


def _trainer(g, kind="gcn", device=CPU, lr=0.05, dropout=0.5, **kw):
    return Trainer(_model(g, kind, dropout), lr=lr, seed=3, device=device, **kw)


def _captures_since(t0):
    return [r for r in profiling.stages() if r.start >= t0 and r.name == "trainer.capture"]


# ------------------------------------------------------------ the CPU


def _separate_reads_fit(trainer, g, epochs, n_classes=4, eval_every=1, early_stopping=None,
                        patience=10, min_epochs=30, log_fn=print):
    """``fit``'s loop as it read the device before the single read: the loss
    after the step, then each of the evaluation's numbers by itself."""
    adj, feats = trainer.prepare(g)
    y = trainer._tensor(g.y, torch.int64)
    train_mask, val_mask = trainer._tensor(g.train_mask), trainer._tensor(g.val_mask)
    history, f1_hist = [], []
    width = len(str(epochs))
    for epoch in range(epochs):
        loss = trainer._train_step(adj, feats, y, train_mask, None, epoch)
        is_eval = (epoch + 1) % eval_every == 0 or epoch == epochs - 1
        if early_stopping == "reference" or is_eval:
            loss = loss.item()
        rec = {"loss": loss}
        if is_eval:
            m = trainer._eval_step(adj, feats, y, train_mask, val_mask, n_classes)
            for k, v in m.items():
                rec[k] = float(v)
            log_fn(f"[{epoch + 1:{width}}] loss: {rec['loss']: .3f}, "
                   f"training accuracy: {rec['train_acc']: .3f}, "
                   f"val_f1: {rec['val_f1']: .3f}")
            if early_stopping == "val_f1":
                f1_hist.append(rec["val_f1"])
                if epoch > min_epochs and len(f1_hist) > patience:
                    dec = sum(f1_hist[-(i + 1)] <= f1_hist[-(patience + 1)]
                              for i in range(patience))
                    if dec >= patience:
                        log_fn(f"Early stopping! Validation f1 decreased for {dec} epochs!")
                        history.append(rec)
                        break
        history.append(rec)
        if (early_stopping == "reference" and epoch > 5 and len(history) >= 5
                and history[-5]["loss"] < history[-1]["loss"]):
            log_fn("early stopping activated!")
            break
    return [{k: float(v) for k, v in rec.items()} for rec in history]


# (fit's keyword arguments, whether the run stops early); lr 2 makes the
# train loss climb back within a few epochs, so the reference rule fires
READ_CASES = {
    "every-epoch": (dict(), False),
    "every-third": (dict(eval_every=3), False),
    "reference-exit": (dict(early_stopping="reference", lr=2.0), True),
    "reference-every-third": (dict(early_stopping="reference", eval_every=3, lr=2.0), True),
    "val_f1-exit": (dict(early_stopping="val_f1", patience=2, min_epochs=3), True),
}


@pytest.mark.parametrize("case", list(READ_CASES))
def test_one_read_an_epoch_gives_the_history_and_log_lines_of_separate_reads(graph, case):
    kw, stops = READ_CASES[case]
    kw = dict(kw)
    lr = kw.pop("lr", 0.05)
    epochs = 30
    runs = []
    # both fits on one intra-op thread: no OpenMP team or threaded BLAS call
    # then orders a sum, however loaded the machine (a run of six test
    # workers once put one f32 ulp between the two, in a case that took
    # 176 s instead of about one)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for fit in ("one read", "separate reads"):
            trainer = _trainer(graph, lr=lr)
            lines = []
            if fit == "one read":
                hist = trainer.fit(graph, epochs=epochs, n_classes=4, verbose=1,
                                   log_fn=lines.append, **kw)
                assert lines.pop().startswith("training took ")
            else:
                hist = _separate_reads_fit(trainer, graph, epochs, log_fn=lines.append, **kw)
            runs.append((hist, lines))
    finally:
        torch.set_num_threads(threads)
    (hist, lines), (ref_hist, ref_lines) = runs
    assert hist == ref_hist
    assert lines == ref_lines
    assert (len(hist) < epochs) == stops
    evaluated = [set(rec) == set(EPOCH_READ) for rec in hist]
    assert sum(evaluated) == len([ln for ln in lines if ln.startswith("[")])


def _key_inputs(trainer, g):
    y = trainer._tensor(g.y, torch.int64)
    masks = trainer._tensor(g.train_mask), trainer._tensor(g.val_mask)
    return (y, *masks, y, masks[0], None, None)


@pytest.mark.parametrize("setting,graphed", [
    (dict(), True),
    (dict(kind="egcn"), True),
    (dict(kind="jk"), True),
    (dict(masked_head=True), True),
    (dict(debug_checks=True), False),
    (dict(use_pallas=False), False),  # the segment path
    (dict(hybrid_k=16), False),
])
def test_which_fits_the_card_would_graph(graph, setting, graphed):
    """The rule, with the trainer's device taken for a card's: the CSR
    kernel's operator on one device without debug checks."""
    trainer = _trainer(graph, **setting)
    adj, _ = trainer.prepare(graph)
    inputs = _key_inputs(trainer, graph)
    trainer.device = torch.device("cuda")
    key = trainer._graph_key(adj, None, inputs, 4)
    assert (key is not None) == graphed


def test_a_mesh_never_graphs(graph):
    trainer = _trainer(graph, mesh=Mesh(None, 0, 1, CPU))
    adj, _ = trainer.prepare(graph)
    inputs = _key_inputs(trainer, graph)
    trainer.device = torch.device("cuda")
    assert trainer._graph_key(adj, None, inputs, 4) is None


@pytest.mark.parametrize("setting", [dict(), dict(debug_checks=True),
                                     dict(mesh=Mesh(None, 0, 1, CPU)), "minibatch"],
                         ids=["cpu", "debug_checks", "mesh", "fit_minibatch"])
def test_the_cpu_never_captures(graph, setting):
    t0 = time.perf_counter()
    if setting == "minibatch":
        trainer = _trainer(graph)
        trainer.fit_minibatch(graph, epochs=2, batch_size=64)
        epochs = 0
    else:
        trainer = _trainer(graph, **setting)
        for _ in range(2):
            trainer.fit(graph, epochs=4, n_classes=4)
        epochs = 8
    assert trainer.graph_stats == {"replayed": 0, "eager": epochs}
    assert trainer._graphs is None and _captures_since(t0) == []


def _ev(name, ts, dur=1, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": 1, "args": {}}


def test_graph_replays_reader_on_a_hand_built_trace():
    read = harness.metric_reader("graph_replays_per_epoch")
    marks = [_ev(tracing.EPOCH_MARK, t) for t in (0, 100, 200)]
    replays = [_ev("fit.replay", base + ts) for base in (0, 100) for ts in (10, 50)]
    # kineto's copy on the device's timeline, and a replay outside the window
    copies = [dict(ev, cat="gpu_user_annotation") for ev in replays]
    outside = [_ev("fit.replay", 250)]
    run = lambda evs: harness.Run(config={}, traffic={}, n_nodes=1, n_edges=1, n_classes=1,
                                  setup_s=1.0, epoch_s=[1e-4, 1e-4], timers={},
                                  trace=tracing.TraceWindow(evs))
    assert read(run(marks + replays + copies + outside)) == 2.0
    assert read(run(marks + outside)) is None
    assert read(harness.Run(config={}, traffic={}, n_nodes=1, n_edges=1, n_classes=1,
                            setup_s=1.0, epoch_s=[1.0], timers={})) is None


# -------------------------------------------------------------- the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _no_op_hooks(trainer):
    """A gradient hook on every parameter: every step of the trainer's fit
    then runs eagerly."""
    return [p.register_post_accumulate_grad_hook(lambda p: None)
            for p in trainer.model.parameters()]


def _state(trainer):
    """Parameters, the optimizer's state and the generator's state, on the host."""
    opt = trainer.optimizer.state_dict()["state"]
    return ([p.detach().cpu() for p in trainer.model.parameters()],
            [{k: v.cpu() for k, v in opt[i].items()} for i in sorted(opt)],
            trainer.generator.get_state())


def _assert_same_state(a, b):
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert len(a[1]) == len(b[1])
    for x, y in zip(a[1], b[1]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    assert torch.equal(a[2], b[2])


def _fits(g, device, kind, eager, fits=(30,), on_epoch=None, fit_kw=None, **kw):
    """A fresh trainer's fits, all-eager or graphed; returns histories,
    state, the CSR launches and the trainer."""
    trainer = _trainer(g, kind, device, **kw)
    if eager:
        _no_op_hooks(trainer)
    launches = spmm_cuda.spmm_csr_kernel.launches
    hists = []
    for n in fits:
        log = (lambda msg: on_epoch(trainer, msg)) if on_epoch else (lambda msg: None)
        hists.append(trainer.fit(g, epochs=n, n_classes=4, verbose=1, log_fn=log,
                                 **(fit_kw or {})))
    torch.cuda.synchronize()
    return hists, _state(trainer), spmm_cuda.spmm_csr_kernel.launches - launches, trainer


GRAPHED = {"gcn": dict(kind="gcn"), "egcn": dict(kind="egcn"), "jk": dict(kind="jk"),
           "gcn-masked-head": dict(kind="gcn", masked_head=True),
           "egcn-masked-head": dict(kind="egcn", masked_head=True),
           # E is captured after the first eager evaluation, at epoch 10
           "gcn-eval-every-5": dict(kind="gcn", fit_kw=dict(eval_every=5)),
           "egcn-reference-every-3": dict(kind="egcn", lr=0.01, fit_kw=dict(
               eval_every=3, early_stopping="reference"))}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(GRAPHED))
def test_graphed_fit_equals_the_eager_fit_bit_for_bit(cuda, graph, case):
    kw = dict(GRAPHED[case])
    kind = kw.pop("kind")
    eager = _fits(graph, cuda, kind, True, **kw)
    graphed = _fits(graph, cuda, kind, False, **kw)
    n = len(eager[0][0])  # the epochs run (an early stop ends them sooner)
    assert eager[3].graph_stats == {"replayed": 0, "eager": n}
    assert graphed[3].graph_stats == {"replayed": n - 1, "eager": 1}
    assert graphed[0] == eager[0]
    _assert_same_state(graphed[1], eager[1])
    assert graphed[2] == eager[2] > 0


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["gcn", "egcn"])
def test_a_hooked_step_runs_eagerly_between_replays(cuda, graph, kind):
    """The benchmark's check: a post-accumulate-grad hook registered at the
    end of epoch k and removed at the end of k + 1 sees step k + 1's
    gradient, and the fit still equals the eager one."""
    k = 7

    def on_epoch(trainer, msg):
        if not msg.startswith("["):
            return
        n = int(msg[1:msg.index("]")])
        if n == k:
            trainer.norms = {}

            def norm(i):
                def hook(p):
                    trainer.norms.setdefault(i, p.grad.double().norm())
                return hook

            trainer.handles = [p.register_post_accumulate_grad_hook(norm(i))
                               for i, p in enumerate(trainer.model.parameters())]
        elif n == k + 1:
            for h in trainer.handles:
                h.remove()

    eager = _fits(graph, cuda, kind, True, on_epoch=on_epoch)
    graphed = _fits(graph, cuda, kind, False, on_epoch=on_epoch)
    assert graphed[3].graph_stats == {"replayed": 28, "eager": 2}
    assert graphed[0] == eager[0]
    _assert_same_state(graphed[1], eager[1])
    assert graphed[2] == eager[2]
    a, b = eager[3].norms, graphed[3].norms
    assert len(a) == len(b) == len(list(graphed[3].model.parameters()))
    assert all(torch.equal(a[i], b[i]) for i in a)


@pytest.mark.gpu
def test_repeated_fits_capture_once(cuda, graph):
    t0 = time.perf_counter()
    eager = _fits(graph, cuda, "gcn", True, fits=(10, 10, 10))
    graphed = _fits(graph, cuda, "gcn", False, fits=(10, 10, 10))
    assert len(_captures_since(t0)) == 2  # T and E, once each
    assert graphed[3].graph_stats == {"replayed": 29, "eager": 1}
    assert graphed[0] == eager[0]
    _assert_same_state(graphed[1], eager[1])
    assert graphed[2] == eager[2] == 3 * 10 * 6


@pytest.mark.gpu
def test_the_profiler_sees_the_kernels_of_a_graph_captured_before_it(cuda, graph, tmp_path):
    trainer = _trainer(graph, "gcn", cuda)
    trainer.fit(graph, epochs=3, n_classes=4)  # the eager epoch, the capture, a replay
    torch.cuda.synchronize()
    launches = spmm_cuda.spmm_csr_kernel.launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer.fit(graph, epochs=3, n_classes=4)
        torch.cuda.synchronize()
    launches = spmm_cuda.spmm_csr_kernel.launches - launches
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [ev for ev in events if ev.get("cat") == "kernel"
               and "spmm_segments_kernel" in ev.get("name", "")]
    replays = [ev for ev in events if ev.get("cat") == "user_annotation"
               and ev.get("name") == "fit.replay"]
    assert trainer.graph_stats == {"replayed": 5, "eager": 1}
    assert launches == 18 and len(replays) == 6
    assert len(kernels) == launches
