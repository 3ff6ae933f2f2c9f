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

Also here: ``init_distributed``'s failure paths (as
tests/test_multihost_2proc.py:59-92 holds JAX's), the flat experiment's
``--train-sharding halo`` on two ranks it starts, its ``--train-sharding
hybrid`` and ``--train-masked-head`` flags in each group against its
single-device row, and the refusals that remain (ROADMAP.md §1 item 4c,
and the options refused for good)."""

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


def np_params(in_dim, seed=5, kind="gcn"):
    """GCN (or EGCN) parameters made in numpy, for both packages."""
    rng = np.random.default_rng(seed)
    dims = [EMBED if kind == "egcn" else in_dim, HIDDEN, N_CLASSES]
    p = lambda *shape: (rng.standard_normal(shape) * 0.1).astype(np.float32)
    out = {"layers": [{"w": p(a, b), "b": p(b)} for a, b in zip(dims[:-1], dims[1:])]}
    if kind == "egcn":
        out["embed"] = {"w": p(in_dim, EMBED), "b": p(EMBED)}
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


def flat_params(model) -> dict:
    """The parameters in the single-device layout (a TP rank gathers its
    blocks: a collective)."""
    from pytextgcn_tpu_torch.models import export_params
    from pytextgcn_tpu_torch.parallel.tensor import gather_params

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

    walk(gather_params(model, export_params(model)), "params")
    return out


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
        yield world, ranks


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
    (["--graph-backend", "sharded"], r"ROADMAP\.md.*§1 item 4c"),
    (["--train-ep", "true"], r"ROADMAP\.md.*§1 item 4c"),
    (["--train-sharding", "halo", "--train-hybrid-k", "128"], r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "allgather", "--train-hybrid-k", "auto"],
     r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "hybrid", "--train-plan-cache", "plans"],
     r"refused for good: ROADMAP\.md"),
    (["--train-sharding", "hybrid", "--train-hybrid-f32-mode", "split2"],
     r"refused for good: ROADMAP\.md"),
], ids=["sharded-counting", "ep", "halo-k", "allgather-k", "plan-cache", "split2"])
def test_remaining_refusals_name_the_roadmap(flag, match):
    from pytextgcn_tpu_torch.experiments import flat

    with pytest.raises(SystemExit, match=match):
        flat.main(["--device", "cpu", "--train-n-devices", "2", *flag])


def test_trainer_refuses_the_masked_head_with_a_mesh():
    """The trainer takes the masked head with a mesh now: the sharded
    restricted head under 'halo' and, on replicated activations, under
    'allgather'. What it still refuses with a mesh: a halo without one, a
    plan cache, a hot set under 'allgather', the split2 mode, a tp_mesh
    beside a graph mesh."""
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
    for kw, match in ((dict(plan_cache="plans", halo=True), "one device's"),
                      (dict(hybrid_k=128), "'allgather' partition"),
                      (dict(halo=True, hybrid_k=128, hybrid_f32_mode="split2"), "split2"),
                      (dict(tp_mesh=mesh), "tp_mesh together")):
        with pytest.raises(ValueError, match=match):
            Trainer(GCN(10, 2, n_hidden_gcn=4), mesh=mesh, **kw)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
