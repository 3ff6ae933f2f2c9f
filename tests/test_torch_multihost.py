"""The port's partitioned training on real process groups: 2 and 4 ranks
over gloo on the CPU.

Each group is started once (a module fixture): every rank runs this file
as a script (its ``__main__`` worker, which imports no JAX), joins the
group with ``init_distributed``, runs every case below and writes its
results to an npz. The tests compare those with the single-process port
(run here) and with the JAX package (imported inside the tests only):

* ``spmm_sharded`` and ``spmm_halo``, forward and backward, against JAX's
  on the same numpy inputs (1e-5; bf16 operands 3e-2);
* GCN trained 10 epochs with dropout 0.5 under 'allgather' and 'halo':
  the losses equal the single-process port's at 1e-5 relative (every rank
  seeds the same dropout generator; a halo rank draws the full mask and
  keeps its rows), the metrics are the single-process ones, and the
  parameters are equal across ranks;
* at dropout 0 and lr 0.005, from parameters made in numpy, both modes
  against JAX's sharded trainers step for step (the trajectory tolerance
  of tests/test_torch_trainer.py);
* EGCN and JK, a short run each in both modes;
* ``save`` on rank 0 and ``restore`` on every rank; the meshes.

The sharded hybrid, the sharded masked head and tensor parallelism run in
the same groups, on a symmetric graph (the hybrid needs weight symmetry):

* ``spmm_hybrid_sharded`` (its dense pair in two products and on the dual
  kernel's plain version) and ``spmm_restricted_sharded`` through their
  real collectives, forward and backward, against JAX's (2e-5 and 1e-4, as
  tests/test_{hybrid,restricted}_sharded.py), with the rows the hybrid's
  collectives moved equal to ``comm_rows_per_device``;
* GCN under 'hybrid', the masked head under 'halo', 'hybrid' and
  'allgather', and EGCN under a ``tp_mesh``, 10 epochs at dropout 0.5,
  against the single-process port (losses rel 2e-4, parameters rtol 5e-4,
  atol 1e-5, as tests/test_restricted_sharded.py:105-129; TP: losses rtol
  2e-4, atol 2e-5, parameters rtol 2e-3, atol 2e-4, as
  tests/test_tensor_parallel.py:63-85), and at dropout 0 against JAX's
  trainers;
* a TP checkpoint saved in the single-device layout and restored into
  every rank's blocks.

The last multi-device paths run in the same groups too:

* the data-parallel MLP step (``train_mlp(mesh=)``) at dropout 0 from the
  JAX package's initial parameters against the single-process port and
  JAX's ``train_mlp(mesh=make_mesh(D, axis="data"))`` (rtol 2e-4, atol
  2e-5, as tests/test_mlp_dp.py), and at dropout 0.3, where it must learn
  (validation macro-F1 >= 0.8) with each rank's masks its own;
* the per-label ensemble across ranks (``train_per_label(mesh=)``) on
  tests/test_perlabel_ep.py's ragged corpus: GCN members against the
  sequential port (dropout 0.5, the hybrid at K = 64 too) and, at dropout
  0, against JAX's ensemble mesh; EGCN and JK members against the port's
  single-device batched run; dummy members padded in at 4 ranks,
  ``save_dir`` written by rank 0 alone, the returned members' optimizer
  state and dropout generators the sequential run's, a member refitted;
  and the per-label experiment's ``--train-ep --train-n-devices N``
  against its single-process row;
* EGCN (embedding 64, hidden 16) cut by columns beside a graph mesh over
  the same ranks, under 'allgather', 'halo' and 'hybrid', at dropout 0
  from numpy parameters: losses within 1e-5 relative of the
  single-process port, the first step's gradients within rtol 1e-3, atol
  1e-5 of JAX's ``Trainer(mesh=, tp_mesh=)``, the parameters equal across
  ranks.

Also here: ``init_distributed``'s failure paths (as
tests/test_multihost_2proc.py:59-92 holds JAX's), the flat experiment's
``--train-sharding halo`` on two ranks it starts, its ``--train-sharding
hybrid`` and ``--train-masked-head`` flags in each group against its
single-device row, and the refusals that remain (the options refused for
good)."""

import functools
import os
import shutil
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:  # run as a script by the ranks
    sys.path.insert(0, ROOT)

from pytextgcn_tpu_torch.core.graph import TextGraph  # noqa: E402

N_CLASSES = 3
# name -> (model, mode, dropout, lr, epochs); '*_np' cases start from
# parameters made in numpy (np_params) and run against JAX
CASES = {
    "gcn_allgather": ("gcn", "allgather", 0.5, 0.05, 10),
    "gcn_halo": ("gcn", "halo", 0.5, 0.05, 10),
    "gcn_allgather_np": ("gcn", "allgather", 0.0, 0.005, 10),
    "gcn_halo_np": ("gcn", "halo", 0.0, 0.005, 10),
    "egcn_allgather": ("egcn", "allgather", 0.5, 0.05, 4),
    "egcn_halo": ("egcn", "halo", 0.5, 0.05, 4),
    "jk_allgather": ("jk", "allgather", 0.5, 0.05, 4),
    "jk_halo": ("jk", "halo", 0.5, 0.05, 4),
}
HIDDEN, EMBED = 16, 12
HOT_K = 64  # the sharded hybrid's hot set on sym_graph()
# the sharded hybrid, the sharded masked head and TP, on sym_graph(): name
# -> (model, trainer options over ranks, dropout, lr, epochs); the
# single-process reference runs the same model with the masked head where
# the case has one, else the CSR path
CASES_4B = {
    "gcn_hybrid": ("gcn", dict(halo=True, hybrid_k=HOT_K), 0.5, 0.05, 10),
    "gcn_hybrid_fused": ("gcn", dict(halo=True, hybrid_k=HOT_K, hybrid_fused=True), 0.5,
                         0.05, 10),
    "gcn_masked_halo": ("gcn", dict(halo=True, masked_head=True), 0.5, 0.05, 10),
    "gcn_masked_hybrid": ("gcn", dict(halo=True, hybrid_k=HOT_K, masked_head=True), 0.5, 0.05,
                          10),
    "gcn_masked_allgather": ("gcn", dict(masked_head=True), 0.5, 0.05, 10),
    "egcn_tp": ("egcn", dict(tp=True), 0.5, 0.05, 10),
    "gcn_hybrid_np": ("gcn", dict(halo=True, hybrid_k=HOT_K), 0.0, 0.005, 10),
    "gcn_masked_halo_np": ("gcn", dict(halo=True, masked_head=True), 0.0, 0.005, 10),
    "egcn_tp_np": ("egcn", dict(tp=True), 0.0, 0.005, 10),
}


def graph(seed=9, n_vocab=90, n_docs=110, n_edges=4000) -> TextGraph:
    """tests/test_halo.py's graph, with train, val and test documents."""
    rng = np.random.default_rng(seed)
    n = n_vocab + n_docs
    part = rng.integers(0, 3, n_docs)
    masks = [np.r_[np.zeros(n_vocab, bool), part == k] for k in range(3)]
    return TextGraph(
        edge_src=rng.integers(0, n, n_edges).astype(np.int32),
        edge_dst=rng.integers(0, n, n_edges).astype(np.int32),
        edge_w=(rng.random(n_edges) + 0.1).astype(np.float32),
        y=rng.integers(0, N_CLASSES, n).astype(np.int32),
        train_mask=masks[0], val_mask=masks[1], test_mask=masks[2],
        n_vocab=n_vocab, n_docs=n_docs)


MASKED = ["--train-masked-head", "true"]
# the flat experiment's flags that ROADMAP.md §1 item 4b refused
FLAGS_4B = {
    "hybrid": ["--train-sharding", "hybrid", "--train-hybrid-k", "128"],
    "masked_halo": ["--train-sharding", "halo", *MASKED],
    "masked_allgather": ["--train-sharding", "allgather", *MASKED],
    "masked_hybrid": ["--train-sharding", "hybrid", "--train-hybrid-k", "128", *MASKED],
}


def flat_argv(graph, result_file, extra):
    """The flat experiment's command line on the CPU on the saved graph, 6
    epochs."""
    return ["--device", "cpu", "--train-epochs", "6", "--train-verbose", "0",
            "--load-graph", graph, "--result-file", result_file, *extra]


def sym_graph(seed=9) -> TextGraph:
    """:func:`graph` with every edge stored in both directions with one
    weight: weight-symmetric, as the hybrid's transposed term needs."""
    import dataclasses

    g = graph(seed, n_edges=2000)
    return dataclasses.replace(g, edge_src=np.concatenate([g.edge_src, g.edge_dst]),
                               edge_dst=np.concatenate([g.edge_dst, g.edge_src]),
                               edge_w=np.concatenate([g.edge_w, g.edge_w]))


def spmm_inputs(g, h=8, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.n_nodes, h)).astype(np.float32),
            rng.standard_normal((g.n_nodes, h)).astype(np.float32))


def np_params(in_dim, seed=5, kind="gcn", embed=EMBED):
    """GCN (or EGCN, embedding ``embed`` wide) parameters made in numpy, for
    both packages."""
    rng = np.random.default_rng(seed)
    dims = [embed if kind == "egcn" else in_dim, HIDDEN, N_CLASSES]
    p = lambda *shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    out = {"layers": [{"w": p(a, b), "b": p(b)} for a, b in zip(dims[:-1], dims[1:])]}
    if kind == "egcn":
        out["embed"] = {"w": p(in_dim, embed), "b": p(embed)}
    return out


def make_model(kind, g, dropout, np_init):
    from pytextgcn_tpu_torch.models import EGCN, GCN, JumpingKnowledgeNetwork, load_jax_params

    gen = torch.Generator().manual_seed(1)
    kw = dict(n_hidden_gcn=HIDDEN, dropout=dropout, generator=gen)
    if kind == "gcn":
        model = GCN(g.in_dim, N_CLASSES, **kw)
    elif kind == "egcn":
        model = EGCN(g.in_dim, N_CLASSES, embedding_dim=EMBED, **kw)
    else:
        model = JumpingKnowledgeNetwork(g.in_dim, N_CLASSES, **kw)
    if np_init:
        load_jax_params(model, np_params(g.in_dim, kind=kind))
    return model


def flatten_tree(tree, path="params") -> dict:
    """A parameter tree's leaves as numpy arrays, keyed by their paths."""
    out = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in sorted(tree):
                walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, t in enumerate(tree):
                walk(t, f"{path}/{i}")
        else:
            out[path] = np.asarray(tree)

    walk(tree, path)
    return out


def flat_params(model) -> dict:
    """The parameters in the single-device layout (a TP rank gathers its
    blocks: a collective)."""
    from pytextgcn_tpu_torch.models import export_params
    from pytextgcn_tpu_torch.parallel.tensor import gather_params

    return flatten_tree(gather_params(model, export_params(model)))


def flat_grads(model) -> dict:
    """The parameters' gradients in the single-device layout (a collective
    under TP)."""
    from pytextgcn_tpu_torch.parallel.tensor import gather_params

    def tree(t):
        if isinstance(t, dict):
            return {k: tree(v) for k, v in t.items()}
        if isinstance(t, list):
            return [tree(v) for v in t]
        return t[0].grad.detach().cpu().numpy().copy()

    return flatten_tree(gather_params(model, tree(model.jax_tree())), "grads")


def run_case(name, g, mesh=None) -> dict:
    """One case's history, metrics and final parameters; ``mesh`` None is
    the single-process port."""
    from pytextgcn_tpu_torch.train import Trainer

    kind, mode, dropout, lr, epochs = CASES[name]
    model = make_model(kind, g, dropout, name.endswith("_np"))
    trainer = Trainer(model, lr=lr, seed=3, device="cpu" if mesh is None else None,
                      mesh=mesh, halo=mesh is not None and mode == "halo")
    hist = trainer.fit(g, epochs=epochs, n_classes=N_CLASSES)
    metrics = trainer.evaluate(g, n_classes=N_CLASSES)
    res = {k: np.array([r[k] for r in hist]) for k in ("loss", "val_loss", "val_f1", "train_acc")}
    res.update(accuracy=np.array(metrics["accuracy"]), f1_macro=np.array(metrics["f1_macro"]))
    res.update(flat_params(model))
    return res


def run_case_4b(name, g, world: int = 0) -> dict:
    """One CASES_4B case, as :func:`run_case`; ``world`` 0 is the
    single-process port."""
    from pytextgcn_tpu_torch.parallel import make_mesh
    from pytextgcn_tpu_torch.train import Trainer

    kind, opts, dropout, lr, epochs = CASES_4B[name]
    model = make_model(kind, g, dropout, name.endswith("_np"))
    if not world:
        kw = dict(device="cpu", masked_head=opts.get("masked_head", False))
    elif opts.get("tp"):
        kw = dict(tp_mesh=make_mesh(world, axis="model", device="cpu"))
    else:
        kw = dict(mesh=make_mesh(world, device="cpu"), **opts)
    trainer = Trainer(model, lr=lr, seed=3, **kw)
    hist = trainer.fit(g, epochs=epochs, n_classes=N_CLASSES)
    metrics = trainer.evaluate(g, n_classes=N_CLASSES)
    res = {k: np.array([r[k] for r in hist]) for k in ("loss", "val_loss", "val_f1", "train_acc")}
    res.update(accuracy=np.array(metrics["accuracy"]), f1_macro=np.array(metrics["f1_macro"]))
    res.update(flat_params(model))
    res["operator"] = np.array(type(trainer._adj).__name__)
    if trainer._adj_out is not None:
        head = getattr(trainer._adj_out, "op", trainer._adj_out)
        res["head"] = np.array(type(trainer._adj_out).__name__ + "/" + type(head).__name__)
    return res


# ------------------------------------------------------------ §1 item 4c

TP_EMBED = 64  # __graft_entry__.py:204-221's EGCN: embedding 64, hidden 16
TP_GRAPH_EPOCHS, TP_GRAPH_LR = 5, 0.005
# EGCN cut by columns beside a graph mesh over the same ranks, on
# sym_graph(): name -> the graph mesh's Trainer options
CASES_TP_GRAPH = {"tp_allgather": {}, "tp_halo": dict(halo=True),
                  "tp_hybrid": dict(halo=True, hybrid_k=HOT_K)}
# tests/test_mlp_dp.py's runs: dropout 0 (from JAX's initial parameters)
# and dropout 0.3
MLP_DP = {"mlp_dp": dict(n_classes=3, hidden=(16,), epochs=30, early_stopping=False,
                         dropout=0.0, seed=9),
          "mlp_dp_dropout": dict(n_classes=3, hidden=(32,), epochs=60, early_stopping=False,
                                 dropout=0.3, seed=1)}
# the ensemble on tests/test_perlabel_ep.py's ragged corpus: name -> (model,
# dropout, the factory's seed, epochs, trainer options); '*_np' cases run
# against JAX's ensemble mesh
CASES_EP = {"ep_gcn": ("gcn", 0.5, 0, 25, {}),
            "ep_gcn_np": ("gcn", 0.0, 5, 20, {}),
            "ep_hybrid": ("gcn", 0.5, 0, 20, {"hybrid_k": 64}),
            "ep_egcn": ("egcn", 0.5, 0, 15, {}),
            "ep_jk": ("jk", 0.5, 0, 15, {})}
EP_SEED = 3


def perlabel_argv(result_file, extra=()):
    """The per-label experiment on the CPU, its synthetic corpus, 6 epochs,
    the batched ensemble."""
    return ["--device", "cpu", "--train-epochs", "6", "--train-verbose", "0",
            "--train-ep", "true", "--result-file", result_file, *extra]


def mlp_splits():
    """tests/test_mlp_dp.py's splits through the port's TF-IDF (bit for bit
    JAX's, tests/test_torch_mlp.py)."""
    from pytextgcn_tpu_torch.baselines import fit_tfidf_splits
    from pytextgcn_tpu_torch.data import synthetic_corpus

    docs, labels = synthetic_corpus(n_docs=190, n_classes=3, seed=17)
    labels = np.asarray(labels)
    idx = np.random.default_rng(0).permutation(len(docs))
    tr, va, te = idx[:120], idx[120:160], idx[160:]
    return fit_tfidf_splits([docs[i] for i in tr], [docs[i] for i in va],
                            [docs[i] for i in te], [labels[tr]], [labels[va]], [labels[te]])


def mlp_layers(flat: dict) -> dict:
    """``{"layers": [{"w", "b"}, ...]}`` of a flattened MLP tree."""
    n = len({k.split("/")[2] for k in flat})
    return {"layers": [{leaf: flat[f"params/layers/{i}/{leaf}"] for leaf in ("w", "b")}
                       for i in range(n)]}


def run_mlp(name, splits, init=None, mesh=None) -> dict:
    """``train_mlp`` on ``splits`` with ``MLP_DP[name]``, from its own
    initial parameters or ``init`` (a JAX parameter tree); ``mesh`` None is
    the single-process port. The history, the parameters and the first
    train-time dropout pattern (dropped entries among the nonzero ones)."""
    from pytextgcn_tpu_torch.baselines import mlp_pipeline as pipeline
    from pytextgcn_tpu_torch.models import MLP, load_jax_params
    from pytextgcn_tpu_torch.models import mlp as mlp_module

    real_mlp, real_dropout, first = pipeline.MLP, mlp_module.dropout, []

    class Fixed(MLP):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            load_jax_params(self, init)

    def spy(x, rate, train, generator=None, *args):
        out = real_dropout(x, rate, train, generator, *args)
        if train and rate and not first:
            first.append(((out == 0) & (x != 0)).cpu().numpy())
        return out

    pipeline.MLP = real_mlp if init is None else Fixed
    mlp_module.dropout = spy
    try:
        model, hist = pipeline.train_mlp(splits.x_train, splits.y_train[0], splits.x_val,
                                         splits.y_val[0], mesh=mesh,
                                         device="cpu" if mesh is None else None, **MLP_DP[name])
    finally:
        pipeline.MLP, mlp_module.dropout = real_mlp, real_dropout
    out = {"history": np.asarray(hist), **flat_params(model)}
    if first:
        out["dropped"] = first[0]
    return out


def ragged_corpus():
    """tests/test_perlabel_ep.py's corpus: 5 child classes over 2 parents,
    members of 3 and 2 classes."""
    from pytextgcn_tpu_torch import Text2Graph
    from pytextgcn_tpu_torch.data import synthetic_corpus

    docs, child, parent = synthetic_corpus(n_docs=150, n_classes=5, n_parents=2, seed=13)
    test_idx = np.random.default_rng(2).choice(len(docs), len(docs) // 5, replace=False)
    g = Text2Graph(min_df=1, window_size=5).fit_transform(docs, child, test_idx=test_idx)
    return g, np.asarray(child), np.asarray(parent)


def ep_factory(kind, dropout, seed):
    from pytextgcn_tpu_torch.models import EGCN, GCN, JumpingKnowledgeNetwork

    gen = torch.Generator().manual_seed(seed)
    kw = dict(n_hidden_gcn=16, dropout=dropout, generator=gen)
    if kind == "egcn":
        return lambda d_in, d_out: EGCN(d_in, d_out, embedding_dim=24, **kw)
    cls = GCN if kind == "gcn" else JumpingKnowledgeNetwork
    return lambda d_in, d_out: cls(d_in, d_out, **kw)


def run_ep(name, corpus, mesh=None, ep=True, save_dir=None) -> dict:
    """One CASES_EP run: over ``mesh``'s ranks, or in this process batched
    (``ep``) or sequential. Each member's parameters, optimizer state and
    dropout generator, the losses, the composed predictions; for 'ep_gcn' a
    refit of member 0 besides."""
    import dataclasses
    import json

    from pytextgcn_tpu_torch.hierarchy import eval_per_label, train_per_label

    kind, dropout, fseed, epochs, opts = CASES_EP[name]
    g, child, parent = corpus
    out = train_per_label(g, child, parent, ep_factory(kind, dropout, fseed), epochs=epochs,
                          seed=EP_SEED, ep=ep, mesh=mesh, save_dir=save_dir,
                          trainer_kwargs=dict(opts, **({} if mesh else {"device": "cpu"})))
    res = {"mapping": np.array(json.dumps(out["mapping"])),
           "losses": np.array([[r["loss"] for r in h] for h in out["histories"]])}
    for i, t in enumerate(out["trainers"]):
        res.update({f"m{i}/{k}": v for k, v in flat_params(t.model).items()})
        res[f"m{i}/generator"] = t.generator.get_state().numpy()
        for j, state in t.optimizer.state_dict()["state"].items():
            res.update({f"m{i}/opt/{j}/{k}": v.cpu().numpy() for k, v in state.items()})
    m = eval_per_label(g, child, parent, out["trainers"], out["mapping"])
    res.update(predictions=m["predictions"], accuracy=np.array(m["accuracy"]))
    if name == "ep_gcn":  # member 0 refits on its own label space
        sel = parent == 0
        local = np.zeros_like(child)
        local[sel] = np.searchsorted(np.unique(child[sel]), child[sel])
        y_local = np.zeros(g.n_nodes, np.int32)
        y_local[g.n_vocab:] = local
        hist = out["trainers"][0].fit(dataclasses.replace(g, y=y_local), epochs=3,
                                      n_classes=len(out["mapping"][0]))
        res["refit_losses"] = np.array([r["loss"] for r in hist])
    return res


def run_tp_graph(name, g, world: int = 0) -> dict:
    """EGCN (embedding ``TP_EMBED``) at dropout 0 from numpy parameters, cut
    by columns beside a graph mesh of ``world`` ranks with
    ``CASES_TP_GRAPH[name]`` (world 0: the single-process port on the CSR
    path): one step, whose gradients (the optimizer's, in the single-device
    layout) it keeps, then ``TP_GRAPH_EPOCHS - 1`` more."""
    from pytextgcn_tpu_torch.models import EGCN, load_jax_params
    from pytextgcn_tpu_torch.parallel import make_mesh
    from pytextgcn_tpu_torch.train import Trainer

    model = EGCN(g.in_dim, N_CLASSES, embedding_dim=TP_EMBED, n_hidden_gcn=HIDDEN, dropout=0.0)
    load_jax_params(model, np_params(g.in_dim, kind="egcn", embed=TP_EMBED))
    kw = dict(device="cpu")
    if world:
        kw = dict(mesh=make_mesh(world, device="cpu"),
                  tp_mesh=make_mesh(world, axis="model", device="cpu"), **CASES_TP_GRAPH[name])
    trainer = Trainer(model, lr=TP_GRAPH_LR, seed=3, **kw)
    hist = trainer.fit(g, epochs=1, n_classes=N_CLASSES)
    grads = flat_grads(model)
    hist += trainer.fit(g, epochs=TP_GRAPH_EPOCHS - 1, n_classes=N_CLASSES)
    res = {"loss": np.array([r["loss"] for r in hist]), **grads, **flat_params(model)}
    res["operator"] = np.array(type(trainer._adj).__name__)
    return res


def worker_4c(res: dict, world: int, rank: int, out_dir: str) -> None:
    """The §1 item 4c cases of one rank, into ``res``."""
    import json

    from pytextgcn_tpu_torch.config import check_ported
    from pytextgcn_tpu_torch.experiments import perlabel
    from pytextgcn_tpu_torch.hierarchy import perlabel as perlabel_module
    from pytextgcn_tpu_torch.parallel import make_mesh

    splits = mlp_splits()
    with np.load(os.path.join(out_dir, "mlp_init.npz")) as z:
        init = mlp_layers(dict(z))
    data_mesh = make_mesh(world, axis="data", device="cpu")
    for name in MLP_DP:
        out = run_mlp(name, splits, init if name == "mlp_dp" else None, data_mesh)
        res.update({f"{name}:{k}": v for k, v in out.items()})

    corpus = ragged_corpus()
    ens = make_mesh(world, axis="ensemble", device="cpu")
    saves = []
    real_save = perlabel_module.save_checkpoint
    perlabel_module.save_checkpoint = lambda *a, **k: saves.append(a[0]) or real_save(*a, **k)
    try:
        for name in CASES_EP:
            save_dir = os.path.join(out_dir, "ep_save") if name == "ep_gcn" else None
            res.update({f"{name}:{k}": v for k, v in run_ep(name, corpus, ens,
                                                          save_dir=save_dir).items()})
    finally:
        perlabel_module.save_checkpoint = real_save
    res["ep_gcn:saves"] = np.array(len(saves))
    with open(os.path.join(out_dir, "ep_save", "class_mapping.json")) as f:
        res["ep_gcn:saved_mapping"] = np.array(json.dumps(
            {int(k): v for k, v in json.load(f).items()}))

    sg = sym_graph()
    for name in CASES_TP_GRAPH:
        res.update({f"{name}:{k}": v for k, v in run_tp_graph(name, sg, world).items()})

    # the per-label experiment's --train-ep over this group (rank 0 writes)
    cfg, levels, route, eval_only = perlabel.parse(perlabel_argv(
        os.path.join(out_dir, "perlabel_ep.csv"), ["--train-n-devices", str(world)]))
    check_ported(cfg, minibatch=False, sharding=False)
    perlabel._main(cfg, levels, route, eval_only)



def worker(rank: int, world: int, address: str, out_dir: str) -> None:
    """One rank: every case, written to ``out_dir/rank{rank}.npz``."""
    import torch.distributed as dist

    from pytextgcn_tpu_torch.ops.spmm import spmm
    from pytextgcn_tpu_torch.parallel import (build_halo_adj, build_hybrid_sharded_adj,
                                              build_restricted_sharded_adj, build_sharded_adj,
                                              global_mesh, host_local_mesh, init_distributed,
                                              make_mesh, spmm_halo, spmm_sharded)
    from pytextgcn_tpu_torch.parallel.sharded import local_block
    from pytextgcn_tpu_torch.train import Trainer

    torch.set_num_threads(1)
    init_distributed(address, world, rank, backend="gloo", device="cpu", timeout_s=120)
    mesh = make_mesh(world, device="cpu")
    res = {"world": np.array(mesh.world_size), "rank": np.array(mesh.rank),
           "global_mesh": np.array(global_mesh(device="cpu").world_size),
           "host_local_mesh": np.array(host_local_mesh(device="cpu").world_size)}

    g = graph()
    x, ct = spmm_inputs(g)
    for use_pallas, tag in ((False, "segment"), (True, "csr")):
        adj = build_sharded_adj(g, mesh, use_pallas=use_pallas)
        xt = torch.from_numpy(x).requires_grad_()
        out = spmm_sharded(adj, xt)
        (out * torch.from_numpy(ct)).sum().backward()
        res[f"spmm_allgather_{tag}"], res[f"grad_allgather_{tag}"] = out.detach(), xt.grad
        for dtype in ("float32", "bfloat16"):
            hadj = build_halo_adj(g, mesh, use_pallas=use_pallas, compute_dtype=dtype)
            xo = local_block(mesh, torch.from_numpy(x), hadj.rows_per).requires_grad_()
            out = spmm_halo(hadj, xo)
            (out * local_block(mesh, torch.from_numpy(ct), hadj.rows_per)).sum().backward()
            res[f"spmm_halo_{tag}_{dtype}"], res[f"grad_halo_{tag}_{dtype}"] = out.detach(), xo.grad
            res["comm_rows"] = np.array(hadj.comm_rows_per_device)

    for name in CASES:
        for k, v in run_case(name, g, mesh).items():
            res[f"{name}:{k}"] = v

    # the sharded hybrid and the sharded masked head through their collectives
    sg = sym_graph()
    xs, cts = spmm_inputs(sg, seed=4)
    for fused in (False, True):
        hadj = build_hybrid_sharded_adj(sg, mesh, hot_k=HOT_K, fused=fused)
        xo = local_block(mesh, torch.from_numpy(xs), hadj.rows_per).requires_grad_()
        out = spmm(hadj, xo)
        (out * local_block(mesh, torch.from_numpy(cts), hadj.rows_per)).sum().backward()
        res[f"spmm_hybrid_{fused}"], res[f"grad_hybrid_{fused}"] = out.detach(), xo.grad
        res["hybrid_wire_rows"] = np.array(hadj.wire_rows + hadj.halo_res.wire_rows)
        res["hybrid_comm_rows"] = np.array(hadj.comm_rows_per_device)
    rows = np.flatnonzero(sg.train_mask)
    for hot_k in (None, HOT_K):
        radj = build_restricted_sharded_adj(sg, rows, mesh, hot_k=hot_k)
        xo = local_block(mesh, torch.from_numpy(xs), radj.rows_per).requires_grad_()
        out = spmm(radj, xo)
        (out * local_block(mesh, torch.from_numpy(cts), radj.rows_per)).sum().backward()
        res[f"spmm_restricted_{hot_k}"], res[f"grad_restricted_{hot_k}"] = out.detach(), xo.grad
    for name in CASES_4B:
        for k, v in run_case_4b(name, sg, world).items():
            res[f"{name}:{k}"] = v

    # the flat experiment's 4b flags, in this group (rank 0 writes the row)
    from pytextgcn_tpu_torch.config import check_ported, parse_config
    from pytextgcn_tpu_torch.experiments import flat

    for tag, flag in FLAGS_4B.items():
        cfg = parse_config(flat_argv(os.path.join(out_dir, "graph.npz"),
                                     os.path.join(out_dir, f"flat_{tag}.csv"),
                                     ["--train-n-devices", str(world), *flag]))
        check_ported(cfg)
        flat._main(cfg)

    # TP: save gathers to the single-device layout, restore cuts it again
    tp_mesh = make_mesh(world, axis="model", device="cpu")
    tp = Trainer(make_model("egcn", sg, 0.5, False), lr=0.05, seed=3, tp_mesh=tp_mesh)
    tp.fit(sg, epochs=2, n_classes=N_CLASSES)
    tp_path = os.path.join(out_dir, "tp_ckpt")
    tp.save(tp_path, epoch=2)
    back = Trainer(make_model("egcn", sg, 0.5, True), lr=0.05, seed=3, tp_mesh=tp_mesh)
    res["tp_restored_epoch"] = np.array(back.restore(tp_path))
    res["tp_restored_equal"] = np.array(all(torch.equal(a, b) for a, b in zip(
        tp.model.parameters(), back.model.parameters())) and all(
        torch.equal(tp.optimizer.state[a][k], back.optimizer.state[b][k])
        for a, b in zip(tp.model.parameters(), back.model.parameters())
        for k in ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")))

    worker_4c(res, world, rank, out_dir)

    # save on rank 0, restore on every rank
    path = os.path.join(out_dir, "ckpt")
    model = make_model("gcn", g, 0.5, False)
    trainer = Trainer(model, lr=0.05, seed=3, mesh=mesh, halo=True)
    trainer.fit(g, epochs=2, n_classes=N_CLASSES)
    trainer.save(path, epoch=2)
    other = Trainer(make_model("gcn", g, 0.5, True), lr=0.05, seed=3, mesh=mesh, halo=True)
    res["restored_epoch"] = np.array(other.restore(path))
    res["restored_equal"] = np.array(all(torch.equal(a, b) for a, b in zip(
        model.parameters(), other.model.parameters())))

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: np.asarray(v.numpy() if torch.is_tensor(v) else v) for k, v in res.items()})
    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def flat_graph(tmp_path_factory):
    """The flat experiment's default graph, built once and saved."""
    from pytextgcn_tpu_torch.config import parse_config
    from pytextgcn_tpu_torch.experiments import flat

    torch.set_num_threads(2)
    path = str(tmp_path_factory.mktemp("flat") / "graph.npz")
    flat.build_graph(parse_config(["--device", "cpu"]))[0].save(path)
    return path


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request, flat_graph):
    """Every rank's results from one group of ``request.param`` ranks (rank
    0's with the flat experiment's rows under ``flat:<FLAGS_4B key>``)."""
    world = request.param
    with tempfile.TemporaryDirectory() as out_dir:
        shutil.copy(flat_graph, os.path.join(out_dir, "graph.npz"))
        np.savez(os.path.join(out_dir, "mlp_init.npz"), **jax_mlp_init())
        env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
        for var in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
            env.pop(var, None)
        address = f"127.0.0.1:{_free_port()}"
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(r), str(world),
                                   address, out_dir], env=env, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=300)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out
        ranks = []
        for r in range(world):
            with np.load(os.path.join(out_dir, f"rank{r}.npz")) as z:
                ranks.append(dict(z))
        for tag in FLAGS_4B:
            with open(os.path.join(out_dir, f"flat_{tag}.csv")) as f:
                ranks[0][f"flat:{tag}"] = f.read().strip().splitlines()
        with open(os.path.join(out_dir, "perlabel_ep.csv")) as f:
            ranks[0]["perlabel:ep"] = f.read().strip().splitlines()
        yield world, ranks


@functools.lru_cache(maxsize=None)
def jax_mlp_init() -> dict:
    """The initial parameters JAX's ``train_mlp`` draws for ``MLP_DP
    ['mlp_dp']`` (``split(PRNGKey(seed))[1]``), flattened."""
    import jax

    from pytextgcn_tpu.models.mlp import MLP as JaxMLP

    kw = MLP_DP["mlp_dp"]
    model = JaxMLP(mlp_splits().x_train.shape[1], kw["n_classes"], list(kw["hidden"]),
                   dropout=kw["dropout"])
    return flatten_tree(jax.tree.map(np.asarray, model.init(
        jax.random.split(jax.random.PRNGKey(kw["seed"]))[1])))


@pytest.fixture(scope="module")
def single():
    """Every case in the single-process port."""
    torch.set_num_threads(2)
    g, sg = graph(), sym_graph()
    return {**{name: run_case(name, g) for name in CASES},
            **{name: run_case_4b(name, sg) for name in CASES_4B}}


def _rows(ranks, key, n):
    return np.concatenate([r[key] for r in ranks])[:n]


def test_group_and_meshes(group):
    world, ranks = group
    for r, res in enumerate(ranks):
        assert (int(res["world"]), int(res["rank"])) == (world, r)
        assert int(res["global_mesh"]) == int(res["host_local_mesh"]) == world


def jax_graph(g):
    from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph

    return JaxTextGraph(**{k: getattr(g, k) for k in (
        "edge_src", "edge_dst", "edge_w", "y", "train_mask", "val_mask", "test_mask",
        "n_vocab", "n_docs")})


@functools.lru_cache(maxsize=None)
def jax_spmms(world):
    """JAX's ``spmm_sharded`` and ``spmm_halo`` (f32 and bf16) on a mesh of
    ``world`` devices, and their x-cotangents, on the workers' inputs."""
    import jax
    import jax.numpy as jnp

    from pytextgcn_tpu.ops.spmm import spmm
    from pytextgcn_tpu.parallel import build_halo_adj, build_sharded_adj, make_mesh
    from pytextgcn_tpu.parallel.halo import spmm_halo

    g = graph()
    jg = jax_graph(g)
    x, ct = map(jnp.asarray, spmm_inputs(g))
    mesh = make_mesh(world)
    jsh, jhalo = build_sharded_adj(jg, mesh), build_halo_adj(jg, mesh)
    fns = {"allgather": lambda v: spmm(jsh, v),
           "halo_float32": lambda v: spmm_halo(jhalo, v),
           "halo_bfloat16": lambda v: spmm_halo(jhalo, v, compute_dtype="bfloat16")}
    out = {"comm_rows": jhalo.comm_rows_per_device}
    for name, f in fns.items():
        out[name] = (np.asarray(jax.jit(f)(x)),
                     np.asarray(jax.jit(jax.grad(lambda v: jnp.vdot(f(v), ct)))(x)))
    return out


@pytest.mark.parametrize("tag", ["segment", "csr"])
def test_spmm_sharded_and_halo_against_jax(group, tag):
    # the port's plan path ("csr") against JAX's segment path; JAX's Pallas
    # shards are held in tests/test_torch_sharded.py
    world, ranks = group
    want = jax_spmms(world)
    for r in ranks:  # the all-gather's output and x-cotangent are replicated
        np.testing.assert_allclose(r[f"spmm_allgather_{tag}"], want["allgather"][0],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(r[f"grad_allgather_{tag}"], want["allgather"][1],
                                   rtol=1e-5, atol=1e-5)
    n = graph().n_nodes
    for dtype, tol in (("float32", 1e-5), ("bfloat16", 3e-2)):
        np.testing.assert_allclose(_rows(ranks, f"spmm_halo_{tag}_{dtype}", n),
                                   want[f"halo_{dtype}"][0], rtol=tol, atol=tol)
        np.testing.assert_allclose(_rows(ranks, f"grad_halo_{tag}_{dtype}", n),
                                   want[f"halo_{dtype}"][1], rtol=tol, atol=tol)
    assert int(ranks[0]["comm_rows"]) == want["comm_rows"]


@pytest.mark.parametrize("name", [c for c in CASES if not c.endswith("_np")])
def test_training_equals_the_single_process_port(group, single, name):
    world, ranks = group
    want = single[name]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}:loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(r[f"{name}:val_loss"], want["val_loss"], rtol=1e-5)
        for key in ("val_f1", "train_acc", "accuracy", "f1_macro"):
            np.testing.assert_allclose(r[f"{name}:{key}"], want[key], rtol=1e-6, atol=1e-7,
                                       err_msg=key)


@pytest.mark.parametrize("name", list(CASES))
def test_parameters_equal_across_ranks(group, name):
    world, ranks = group
    keys = [k for k in ranks[0] if k.startswith(f"{name}:params/")]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("mode", ["allgather", "halo"])
def test_dropout_free_run_follows_jax_sharded_trainer(group, mode):
    import jax
    import jax.numpy as jnp

    from pytextgcn_tpu.models import GCN as JaxGCN
    from pytextgcn_tpu.parallel import make_mesh
    from pytextgcn_tpu.train import Trainer as JaxTrainer

    world, ranks = group
    g = graph()
    jg = jax_graph(g)
    _, _, dropout, lr, epochs = CASES[f"gcn_{mode}_np"]
    jt = JaxTrainer(JaxGCN(jg.in_dim, N_CLASSES, n_hidden_gcn=HIDDEN, dropout=dropout), lr=lr,
                    mesh=make_mesh(world), halo=mode == "halo")
    jt.params = jax.tree.map(jnp.asarray, np_params(g.in_dim))
    jhist = jt.fit(jg, epochs=epochs, n_classes=N_CLASSES)
    name = f"gcn_{mode}_np"
    for key in ("loss", "val_loss", "val_f1", "train_acc"):
        np.testing.assert_allclose(ranks[0][f"{name}:{key}"], [h[key] for h in jhist],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    for i, layer in enumerate(jt.params["layers"]):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(ranks[0][f"{name}:params/layers/{i}/{leaf}"],
                                       np.asarray(layer[leaf]), rtol=1e-4, atol=1e-5)


def test_save_on_rank0_restore_everywhere(group):
    world, ranks = group
    for r in ranks:
        assert int(r["restored_epoch"]) == 2 and bool(r["restored_equal"])


@functools.lru_cache(maxsize=None)
def jax_4b_spmms(world):
    """JAX's sharded hybrid and sharded restricted head on the workers'
    inputs, and their x-cotangents."""
    import jax
    import jax.numpy as jnp

    from pytextgcn_tpu.ops.spmm import spmm
    from pytextgcn_tpu.parallel import (build_hybrid_sharded_adj, build_restricted_sharded_adj,
                                        make_mesh)

    sg = sym_graph()
    jg = jax_graph(sg)
    x, ct = map(jnp.asarray, spmm_inputs(sg, seed=4))
    mesh = make_mesh(world)
    rows = np.flatnonzero(sg.train_mask)
    adjs = {"hybrid": build_hybrid_sharded_adj(jg, mesh, hot_k=HOT_K)}
    for hot_k in (None, HOT_K):
        adjs[f"restricted_{hot_k}"] = build_restricted_sharded_adj(jg, rows, mesh, hot_k=hot_k)
    out = {"hybrid_comm_rows": adjs["hybrid"].comm_rows_per_device}
    for name, adj in adjs.items():
        f = lambda v, a=adj: spmm(a, v)
        out[name] = (np.asarray(jax.jit(f)(x)),
                     np.asarray(jax.jit(jax.grad(lambda v: jnp.vdot(f(v), ct)))(x)))
    return out


def test_hybrid_and_restricted_spmms_against_jax(group):
    # through the real all_gather / all_reduce and the halo ring, forward
    # and backward; the hybrid's collectives moved comm_rows_per_device rows
    world, ranks = group
    want = jax_4b_spmms(world)
    n = sym_graph().n_nodes
    for fused in (False, True):
        np.testing.assert_allclose(_rows(ranks, f"spmm_hybrid_{fused}", n), want["hybrid"][0],
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(_rows(ranks, f"grad_hybrid_{fused}", n), want["hybrid"][1],
                                   rtol=2e-5, atol=2e-5)
    for hot_k in (None, HOT_K):
        for i, key in enumerate(("spmm", "grad")):
            np.testing.assert_allclose(_rows(ranks, f"{key}_restricted_{hot_k}", n),
                                       want[f"restricted_{hot_k}"][i], rtol=1e-4, atol=1e-5)
    for r in ranks:
        assert int(r["hybrid_comm_rows"]) == want["hybrid_comm_rows"]
        assert int(r["hybrid_wire_rows"]) == want["hybrid_comm_rows"]


@pytest.mark.parametrize("name", [c for c in CASES_4B if not c.endswith("_np")])
def test_4b_training_follows_the_single_process_port(group, single, name):
    world, ranks = group
    want = single[name]
    opts = CASES_4B[name][1]
    tp = opts.get("tp", False)
    for r in ranks:
        if opts.get("hybrid_k"):
            assert str(r[f"{name}:operator"]) == "HybridShardedAdj"
        if opts.get("masked_head"):
            assert str(r[f"{name}:head"]).split("/")[0] == (
                "HaloAdj" if opts.get("halo") else "ReplicatedHead")
        np.testing.assert_allclose(r[f"{name}:loss"], want["loss"],
                                   **(dict(rtol=2e-4, atol=2e-5) if tp else dict(rtol=2e-4)))
        for k in (k for k in want if k.startswith("params/")):
            np.testing.assert_allclose(r[f"{name}:{k}"], want[k],
                                       **(dict(rtol=2e-3, atol=2e-4) if tp
                                          else dict(rtol=5e-4, atol=1e-5)), err_msg=k)
        assert r[f"{name}:accuracy"] == pytest.approx(float(want["accuracy"]), abs=0.02)


@pytest.mark.parametrize("name", list(CASES_4B))
def test_4b_parameters_equal_across_ranks(group, name):
    world, ranks = group
    keys = [k for k in ranks[0] if k.startswith(f"{name}:params/")]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


@pytest.mark.parametrize("name", [c for c in CASES_4B if c.endswith("_np")])
def test_4b_dropout_free_runs_follow_jax_trainers(group, name):
    # from parameters made in numpy at dropout 0: JAX's sharded hybrid,
    # masked head over a mesh and TP trainers, step for step
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from pytextgcn_tpu.models import EGCN as JaxEGCN
    from pytextgcn_tpu.models import GCN as JaxGCN
    from pytextgcn_tpu.parallel import make_mesh
    from pytextgcn_tpu.train import Trainer as JaxTrainer

    world, ranks = group
    sg = sym_graph()
    jg = jax_graph(sg)
    kind, opts, dropout, lr, epochs = CASES_4B[name]
    if kind == "egcn":
        model = JaxEGCN(jg.in_dim, N_CLASSES, embedding_dim=EMBED, n_hidden_gcn=HIDDEN,
                        dropout=dropout)
        kw = dict(tp_mesh=JaxMesh(np.array(jax.devices()[:world]), ("model",)))
    else:
        model = JaxGCN(jg.in_dim, N_CLASSES, n_hidden_gcn=HIDDEN, dropout=dropout)
        kw = dict(mesh=make_mesh(world), **opts)
    jt = JaxTrainer(model, lr=lr, **kw)
    jt.params = jax.tree.map(jnp.asarray, np_params(sg.in_dim, kind=kind))
    jhist = jt.fit(jg, epochs=epochs, n_classes=N_CLASSES)
    for key in ("loss", "val_loss", "val_f1", "train_acc"):
        np.testing.assert_allclose(ranks[0][f"{name}:{key}"], [h[key] for h in jhist],
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    want = {}

    def walk(tree, path):
        if isinstance(tree, dict):
            for k in tree:
                walk(tree[k], f"{path}/{k}")
        elif isinstance(tree, list):
            for i, t in enumerate(tree):
                walk(t, f"{path}/{i}")
        else:
            want[path] = np.asarray(tree)

    walk(jt.params, "params")
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0][f"{name}:{k}"], v, rtol=1e-4, atol=1e-5, err_msg=k)


def test_tp_checkpoint_restores_every_rank_s_blocks(group):
    world, ranks = group
    for r in ranks:
        assert int(r["tp_restored_epoch"]) == 2 and bool(r["tp_restored_equal"])


# ------------------------------------------------------------ §1 item 4c

EP_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_perlabel_ep.py:39-56
EP_HYBRID_TOL = dict(rtol=5e-4, atol=5e-5)  # tests/test_perlabel_ep.py:130-160


@pytest.fixture(scope="module")
def single_4c():
    """The 4c cases' references in the single-process port: the MLP from
    JAX's initial parameters, the sequential ensembles ('ep_gcn',
    'ep_hybrid'), the batched ones ('ep_egcn', 'ep_jk'), EGCN on the CSR
    path."""
    torch.set_num_threads(2)
    corpus = ragged_corpus()
    out = {"mlp_dp": run_mlp("mlp_dp", mlp_splits(), mlp_layers(jax_mlp_init())),
           "tp": run_tp_graph("tp_allgather", sym_graph())}
    for name in ("ep_gcn", "ep_hybrid"):
        out[name] = run_ep(name, corpus, ep=False)
    for name in ("ep_egcn", "ep_jk"):
        out[name] = run_ep(name, corpus, ep=True)
    return out


@functools.lru_cache(maxsize=None)
def jax_mlp_dp(world):
    """JAX's data-parallel ``train_mlp`` over ``world`` devices."""
    from pytextgcn_tpu.baselines import fit_tfidf_splits as jax_splits
    from pytextgcn_tpu.baselines.mlp_pipeline import train_mlp as jax_train_mlp
    from pytextgcn_tpu.data import synthetic_corpus as jax_corpus
    from pytextgcn_tpu.parallel import make_mesh

    docs, labels = jax_corpus(n_docs=190, n_classes=3, seed=17)
    labels = np.asarray(labels)
    idx = np.random.default_rng(0).permutation(len(docs))
    tr, va, te = idx[:120], idx[120:160], idx[160:]
    sp_ = jax_splits([docs[i] for i in tr], [docs[i] for i in va], [docs[i] for i in te],
                     [labels[tr]], [labels[va]], [labels[te]])
    _, params, hist = jax_train_mlp(sp_.x_train, sp_.y_train[0], sp_.x_val, sp_.y_val[0],
                                    mesh=make_mesh(world, axis="data"), **MLP_DP["mlp_dp"])
    import jax

    return np.asarray(hist), flatten_tree(jax.tree.map(np.asarray, params))


def test_dp_mlp_matches_the_single_process_port_and_jax(group, single_4c):
    """Dropout 0 from JAX's initial parameters: every rank's history and
    parameters against the single process's and JAX's data-parallel run
    (tests/test_mlp_dp.py:28-47)."""
    world, ranks = group
    want = single_4c["mlp_dp"]
    jhist, jparams = jax_mlp_dp(world)
    keys = [k for k in want if k.startswith("params/")]
    assert keys and set(keys) == set(jparams)
    for r in ranks:
        np.testing.assert_allclose(r["mlp_dp:history"], want["history"], **EP_TOL)
        np.testing.assert_allclose(r["mlp_dp:history"], jhist, **EP_TOL)
        for k in keys:
            np.testing.assert_allclose(r[f"mlp_dp:{k}"], want[k], **EP_TOL, err_msg=k)
            np.testing.assert_allclose(r[f"mlp_dp:{k}"], jparams[k], **EP_TOL, err_msg=k)


def test_dp_mlp_with_dropout_learns_with_masks_of_its_own(group):
    """Dropout 0.3: it learns (tests/test_mlp_dp.py:50-59), and each rank
    draws its own masks, none the parameters' stream."""
    from pytextgcn_tpu_torch.baselines.mlp_pipeline import rank_dropout_seed

    world, ranks = group
    seed = MLP_DP["mlp_dp_dropout"]["seed"]
    masks = [r["mlp_dp_dropout:dropped"] for r in ranks]
    for r, mask in enumerate(masks):
        assert r == 0 or rank_dropout_seed(seed, r) != rank_dropout_seed(seed, 0)
        assert ranks[r]["mlp_dp_dropout:history"][-1][1] >= 0.8
        assert 0.2 < mask.mean() < 0.4  # the rate, among entries the mask saw
        params_stream = torch.rand(mask.shape, generator=torch.Generator().manual_seed(seed))
        assert not np.array_equal(mask, (params_stream >= 0.7).numpy())
    for a in range(world):
        for b in range(a + 1, world):
            assert not np.array_equal(masks[a], masks[b]), (a, b)


@pytest.mark.parametrize("name", [*MLP_DP, *CASES_EP, *CASES_TP_GRAPH])
def test_4c_parameters_equal_across_ranks(group, name):
    world, ranks = group
    keys = [k for k in ranks[0] if k.startswith(f"{name}:") and "params/" in k]
    assert keys
    for r in ranks[1:]:
        for k in keys:
            assert np.array_equal(r[k], ranks[0][k]), k


def _member_keys(res, name):
    return [k for k in res if k.startswith(f"{name}:m") and "/params/" in k]


@pytest.mark.parametrize("name", ["ep_gcn", "ep_hybrid"])
def test_ep_across_ranks_matches_the_sequential_port(group, single_4c, name):
    """GCN members (dropout 0.5, each its sequential stream), the hybrid at
    K = 64 too: mapping, parameters, losses and composed accuracy."""
    world, ranks = group
    want = single_4c[name]
    tol = EP_HYBRID_TOL if CASES_EP[name][4] else EP_TOL
    keys = [k.split(":", 1)[1] for k in _member_keys(ranks[0], name)]
    assert len({k.split("/")[0] for k in keys}) == 2  # the two real members only
    for r in ranks:
        assert str(r[f"{name}:mapping"]) == str(want["mapping"])
        np.testing.assert_allclose(r[f"{name}:losses"], want["losses"], **tol)
        for k in keys:
            np.testing.assert_allclose(r[f"{name}:{k}"], want[k], **tol, err_msg=k)
        assert float(r[f"{name}:accuracy"]) == pytest.approx(float(want["accuracy"]), abs=1e-6)


def test_ep_across_ranks_matches_jax_ensemble_mesh(group):
    """Dropout 0 from shared initial parameters: JAX's
    ``train_per_label(mesh=make_mesh(D, axis="ensemble"))``
    (tests/test_perlabel_ep.py:36-56)."""
    import jax
    import jax.numpy as jnp

    from pytextgcn_tpu.hierarchy import train_per_label as jax_train_per_label
    from pytextgcn_tpu.models import GCN as JaxGCN
    from pytextgcn_tpu.parallel import make_mesh
    from pytextgcn_tpu_torch.models import export_params

    world, ranks = group
    g, child, parent = ragged_corpus()
    kind, dropout, fseed, epochs, _ = CASES_EP["ep_gcn_np"]
    fresh = ep_factory(kind, dropout, fseed)
    c_list = [len(np.unique(child[parent == c])) for c in range(2)]
    inits = [export_params(fresh(g.in_dim, c)) for c in c_list]
    made = []

    class _Fixed(JaxGCN):
        def init(self, key):
            return jax.tree.map(jnp.asarray, self.params)

    def jax_factory(d_in, d_out):
        model = _Fixed(d_in, d_out, n_hidden_gcn=16, dropout=0.0)
        model.params = inits[len(made)]
        made.append(model)
        return model

    jep = jax_train_per_label(g, child, parent, jax_factory, epochs=epochs, seed=EP_SEED,
                              mesh=make_mesh(world, axis="ensemble"))
    for r in ranks:
        for i, jt in enumerate(jep["trainers"]):
            for k, v in flatten_tree(jax.tree.map(np.asarray, jt.params)).items():
                np.testing.assert_allclose(r[f"ep_gcn_np:m{i}/{k}"], v, **EP_TOL, err_msg=k)


@pytest.mark.parametrize("name", ["ep_egcn", "ep_jk"])
def test_ep_egcn_and_jk_across_ranks_match_the_batched_run(group, single_4c, name):
    """EGCN and JK members against the port's single-device batched run
    (the JAX EP step truncates the JK network's last GCN layer, ROADMAP.md
    §3); each parameter within 2e-4 of its largest magnitude, the JK
    attention bias left out (tests/test_torch_perlabel_ep.py)."""
    world, ranks = group
    want = single_4c[name]
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}:losses"], want["losses"], **EP_TOL)
        np.testing.assert_array_equal(r[f"{name}:predictions"], want["predictions"])
        for k in (k.split(":", 1)[1] for k in _member_keys(r, name)):
            if not k.endswith("/att/b"):
                w = want[k]
                np.testing.assert_allclose(r[f"{name}:{k}"], w, rtol=0,
                                           atol=2e-4 * np.abs(w).max(), err_msg=k)


def test_ep_members_carry_their_state_and_refit(group, single_4c):
    """The returned members hold the sequential run's optimizer state and
    dropout generator (gathered from the rank that stepped them), and
    refit; rank 0 alone wrote ``save_dir``."""
    world, ranks = group
    want = single_4c["ep_gcn"]
    opt_keys = [k for k in want if "/opt/" in k]
    assert opt_keys
    for rank, r in enumerate(ranks):
        for k in opt_keys:
            np.testing.assert_allclose(r[f"ep_gcn:{k}"], want[k], **EP_TOL, err_msg=k)
        for i in range(2):
            assert np.array_equal(r[f"ep_gcn:m{i}/generator"], want[f"m{i}/generator"])
        assert len(r["ep_gcn:refit_losses"]) == 3 and np.isfinite(r["ep_gcn:refit_losses"]).all()
        assert int(r["ep_gcn:saves"]) == (2 if rank == 0 else 0)
        assert str(r["ep_gcn:saved_mapping"]) == str(want["mapping"])


@pytest.fixture(scope="module")
def single_perlabel_row(tmp_path_factory):
    """The per-label experiment's ``--train-ep`` row in one process."""
    from pytextgcn_tpu_torch.experiments import perlabel

    path = tmp_path_factory.mktemp("perlabel") / "one.csv"
    perlabel.main(perlabel_argv(str(path)))
    return path.read_text().strip().splitlines()


def test_perlabel_experiment_ep_over_ranks_writes_the_single_process_row(
        group, single_perlabel_row):
    world, ranks = group
    lines = ranks[0]["perlabel:ep"]
    assert len(lines) == 2 and lines[0] == single_perlabel_row[0]  # rank 0's row alone
    got = [float(v) for v in lines[1].split(",")[3:]]
    want = [float(v) for v in single_perlabel_row[1].split(",")[3:]]
    np.testing.assert_allclose(got, want, rtol=1e-6)


@pytest.mark.parametrize("name", list(CASES_TP_GRAPH))
def test_tp_beside_a_graph_mesh_follows_the_single_process_port(group, single_4c, name):
    world, ranks = group
    want = single_4c["tp"]
    opts = CASES_TP_GRAPH[name]
    op = ("HybridShardedAdj" if opts.get("hybrid_k") else "HaloAdj") if opts else "ShardedAdj"
    for r in ranks:
        assert str(r[f"{name}:operator"]) == op
        np.testing.assert_allclose(r[f"{name}:loss"], want["loss"], rtol=1e-5)


@functools.lru_cache(maxsize=None)
def jax_tp_graph_grads(world, name):
    """The first step's gradients of JAX's ``Trainer(mesh=make_mesh(D),
    tp_mesh=...)`` from the workers' numpy parameters."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from pytextgcn_tpu.models import EGCN as JaxEGCN
    from pytextgcn_tpu.parallel import make_mesh
    from pytextgcn_tpu.train import Trainer as JaxTrainer
    from pytextgcn_tpu.train.metrics import masked_cross_entropy as jax_ce

    sg = sym_graph()
    jg = jax_graph(sg)
    jt = JaxTrainer(JaxEGCN(jg.in_dim, N_CLASSES, embedding_dim=TP_EMBED, n_hidden_gcn=HIDDEN,
                            dropout=0.0), lr=TP_GRAPH_LR, mesh=make_mesh(world),
                    tp_mesh=JaxMesh(np.array(jax.devices()[:world]), ("model",)),
                    **CASES_TP_GRAPH[name])
    jt.params = jax.tree.map(jnp.asarray, np_params(sg.in_dim, kind="egcn", embed=TP_EMBED))
    adj, feats = jt.prepare(jg)
    jt._init_state(jax.random.PRNGKey(0))
    y, mask = np.asarray(sg.y), np.asarray(sg.train_mask)
    pad = (getattr(adj, "n_pad", None) or sg.n_nodes) - sg.n_nodes
    y, mask = jnp.asarray(np.pad(y, (0, pad))), jnp.asarray(np.pad(mask, (0, pad)))
    grads = jax.jit(jax.grad(lambda p: jax_ce(jt.model.apply(p, adj, feats, train=False),
                                              y, mask)))(jt.params)
    return flatten_tree(jax.tree.map(np.asarray, grads), "grads")


@pytest.mark.parametrize("name", list(CASES_TP_GRAPH))
def test_tp_beside_a_graph_mesh_gradients_match_jax(group, single_4c, name):
    world, ranks = group
    want = jax_tp_graph_grads(world, name)
    assert set(want) == {k for k in single_4c["tp"] if k.startswith("grads/")}
    for r in ranks:
        for k, v in want.items():
            np.testing.assert_allclose(r[f"{name}:{k}"], v, rtol=1e-3, atol=1e-5, err_msg=k)


# ------------------------------------------------------------ in this process


def test_init_distributed_reraises_explicit_cluster_failure(monkeypatch):
    """A cluster that was asked for but fails to form raises, and nothing
    is latched; a real unreachable coordinator raises too."""
    import torch.distributed as dist

    from pytextgcn_tpu_torch.parallel import multihost

    monkeypatch.setattr(multihost, "_init_done", False)

    def boom(*args, **kwargs):
        raise RuntimeError("failed to connect to coordinator")

    monkeypatch.setattr(dist, "init_process_group", boom)
    with pytest.raises(RuntimeError, match="coordinator"):
        multihost.init_distributed("10.0.0.1:1234", num_processes=2, process_id=0)
    assert multihost._init_done is False
    monkeypatch.undo()
    monkeypatch.setattr(multihost, "_init_done", False)
    with pytest.raises(Exception):  # nothing listens there
        multihost.init_distributed(f"127.0.0.1:{_free_port()}", num_processes=2, process_id=1,
                                   backend="gloo", timeout_s=1)
    assert multihost._init_done is False and not dist.is_initialized()


def test_init_distributed_without_environment_is_a_group_of_one(monkeypatch):
    import torch.distributed as dist

    from pytextgcn_tpu_torch.parallel import make_mesh, multihost

    for var in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(multihost, "_init_done", False)
    try:
        multihost.init_distributed(backend="gloo")
        assert multihost._init_done and dist.get_world_size() == 1 and dist.get_rank() == 0
        mesh = make_mesh(device="cpu")
        assert (mesh.world_size, mesh.rank, mesh.backend) == (1, 0, "gloo")
        with pytest.raises(ValueError, match="group of 2 ranks"):
            make_mesh(2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_flat_experiment_halo_on_two_ranks_writes_the_single_device_row(tmp_path):
    from pytextgcn_tpu_torch.experiments import flat

    args = ["--device", "cpu", "--train-epochs", "8", "--train-verbose", "0"]
    one, two = tmp_path / "one.csv", tmp_path / "two.csv"
    res = flat.main(args + ["--result-file", str(one)])
    assert flat.main(args + ["--result-file", str(two), "--train-sharding", "halo",
                             "--train-n-devices", "2"]) is None
    row1, row2 = (p.read_text().strip().splitlines() for p in (one, two))
    assert len(row2) == 2 and row2[0] == row1[0]  # the header and one row, rank 0's
    got = [float(v) for v in row2[1].split(",")[3:]]
    want = [float(v) for v in row1[1].split(",")[3:]]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == pytest.approx([res["f1_macro"], res["accuracy"]], rel=1e-6)


@pytest.fixture(scope="module")
def single_rows(flat_graph, tmp_path_factory):
    """The flat experiment's single-device rows on the saved graph, without
    and with the masked head: ``{masked: (its result, the row's metrics)}``."""
    from pytextgcn_tpu_torch.experiments import flat

    d = tmp_path_factory.mktemp("single")
    out = {}
    for masked in (False, True):
        path = d / f"one_{masked}.csv"
        res = flat.main(flat_argv(flat_graph, str(path), MASKED if masked else []))
        out[masked] = (res, [float(v) for v in path.read_text().strip().splitlines()[-1]
                             .split(",")[3:]])
    return out


def _ranks_wrote_the_single_device_row(group, single_rows, tag):
    """The group's flat run with ``FLAGS_4B[tag]`` wrote the row of the
    single-device run (with the masked head where the flags have it)."""
    world, ranks = group
    one, want = single_rows["--train-masked-head" in FLAGS_4B[tag]]
    lines = ranks[0][f"flat:{tag}"]
    assert len(lines) == 2  # the header and one row, rank 0's
    got = [float(v) for v in lines[1].split(",")[3:]]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got == pytest.approx([one["f1_macro"], one["accuracy"]], rel=1e-6)


@pytest.mark.parametrize("flag", ["hybrid", "masked_halo"])
def test_refusals_name_item_4b(group, single_rows, flag):
    """The flags that ROADMAP.md §1 item 4b refused now pass check_ported
    and run: the group's flat experiment writes the single-device row."""
    from pytextgcn_tpu_torch.config import check_ported, parse_config

    check_ported(parse_config(["--device", "cpu", "--train-n-devices", "2", *FLAGS_4B[flag]]))
    _ranks_wrote_the_single_device_row(group, single_rows, flag)


@pytest.mark.parametrize("tag", ["masked_allgather", "masked_hybrid"])
def test_flat_experiment_masked_head_over_ranks(group, single_rows, tag):
    _ranks_wrote_the_single_device_row(group, single_rows, tag)


@pytest.mark.parametrize("flag, match", [
    (["--train-sharding", "halo", "--train-hybrid-k", "128"], r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "allgather", "--train-hybrid-k", "auto"],
     r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "hybrid", "--train-plan-cache", "plans"],
     r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "hybrid", "--train-hybrid-f32-mode", "split2"],
     r"refused for good: ROADMAP\.md"),
], ids=["halo-k", "allgather-k", "plan-cache", "split2"])
def test_remaining_refusals_name_the_roadmap(flag, match):
    from pytextgcn_tpu_torch.experiments import flat

    with pytest.raises(SystemExit, match=match):
        flat.main(["--device", "cpu", "--train-n-devices", "2", *flag])


@pytest.fixture(scope="module")
def native_flat_row(tmp_path_factory):
    from pytextgcn_tpu_torch.experiments import flat

    path = tmp_path_factory.mktemp("native") / "row.csv"
    flat.main(["--device", "cpu", "--train-epochs", "3", "--train-verbose", "0",
               "--result-file", str(path)])
    return path.read_text().strip().splitlines()


@pytest.mark.parametrize("flag", [["--graph-backend", "sharded"], ["--train-ep", "true"]],
                         ids=["sharded-counting", "ep"])
def test_item_4c_flags_pass_and_run(group, single_perlabel_row, native_flat_row, tmp_path, flag):
    """What ROADMAP.md §1 item 4c refused passes check_ported over ranks and
    runs: the flat experiment counting on the sharded backend writes the
    native build's row; the group's per-label ``--train-ep`` wrote the
    single-process row (test_perlabel_experiment_ep_over_ranks_...)."""
    from pytextgcn_tpu_torch.config import check_ported, parse_config
    from pytextgcn_tpu_torch.experiments import flat

    check_ported(parse_config(["--device", "cpu", "--train-n-devices", "2", *flag]),
                 minibatch=False, sharding=False)
    if flag[0] == "--graph-backend":
        path = tmp_path / "row.csv"
        flat.main(["--device", "cpu", "--train-epochs", "3", "--train-verbose", "0",
                   "--result-file", str(path), *flag])
        assert path.read_text().strip().splitlines() == native_flat_row
    else:
        world, ranks = group
        got = ranks[0]["perlabel:ep"]
        assert got[0] == single_perlabel_row[0] and len(got) == 2


def test_trainer_refuses_the_masked_head_with_a_mesh():
    """The trainer takes the masked head with a mesh now: the sharded
    restricted head under 'halo' and, on replicated activations, under
    'allgather'; and a tp_mesh beside a graph mesh over the same ranks.
    What it still refuses with a mesh: a halo without one, a plan cache, a
    hot set under 'allgather', the split2 mode, a tp_mesh over other
    ranks."""
    from pytextgcn_tpu_torch.models import GCN
    from pytextgcn_tpu_torch.parallel import HaloAdj, Mesh, ReplicatedHead
    from pytextgcn_tpu_torch.train import Trainer

    g = graph()
    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    for halo, kind in ((True, HaloAdj), (False, ReplicatedHead)):
        t = Trainer(GCN(g.in_dim, N_CLASSES, n_hidden_gcn=4), mesh=mesh, halo=halo,
                    masked_head=True)
        assert isinstance(t._prepare_restricted(g), kind)
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(GCN(10, 2, n_hidden_gcn=4), device="cpu", halo=True)
    assert Trainer(GCN(10, 2, n_hidden_gcn=4), mesh=mesh, tp_mesh=mesh).tp_mesh is mesh
    for kw, match in ((dict(plan_cache="plans", halo=True), "one device's"),
                      (dict(hybrid_k=128), "'allgather' partition"),
                      (dict(halo=True, hybrid_k=128, hybrid_f32_mode="split2"), "split2"),
                      (dict(tp_mesh=Mesh(None, 1, 2, torch.device("cpu"))), "same ranks")):
        with pytest.raises(ValueError, match=match):
            Trainer(GCN(10, 2, n_hidden_gcn=4), mesh=mesh, **kw)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
