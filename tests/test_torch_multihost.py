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

Also here: ``init_distributed``'s failure paths (as
tests/test_multihost_2proc.py:59-92 holds JAX's), the flat experiment's
``--train-sharding halo --train-n-devices 2`` on the CPU against its
single-device row, and the refusals that name ROADMAP.md §1 item 4b."""

import functools
import os
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


def spmm_inputs(g, h=8, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g.n_nodes, h)).astype(np.float32),
            rng.standard_normal((g.n_nodes, h)).astype(np.float32))


def np_params(in_dim, seed=5):
    """GCN parameters made in numpy, for both packages."""
    rng = np.random.default_rng(seed)
    dims = [in_dim, HIDDEN, N_CLASSES]
    return {"layers": [{"w": (rng.standard_normal((a, b)) * 0.1).astype(np.float32),
                        "b": (rng.standard_normal(b) * 0.1).astype(np.float32)}
                       for a, b in zip(dims[:-1], dims[1:])]}


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
        load_jax_params(model, np_params(g.in_dim))
    return model


def flat_params(model) -> dict:
    from pytextgcn_tpu_torch.models import export_params

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

    walk(export_params(model), "params")
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


def worker(rank: int, world: int, address: str, out_dir: str) -> None:
    """One rank: every case, written to ``out_dir/rank{rank}.npz``."""
    import torch.distributed as dist

    from pytextgcn_tpu_torch.parallel import (build_halo_adj, build_sharded_adj, global_mesh,
                                              host_local_mesh, init_distributed, make_mesh,
                                              spmm_halo, spmm_sharded)
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


@pytest.fixture(scope="module", params=[2, 4], ids=["2ranks", "4ranks"])
def group(request):
    """Every rank's results from one group of ``request.param`` ranks."""
    world = request.param
    with tempfile.TemporaryDirectory() as out_dir:
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
        yield world, ranks


@pytest.fixture(scope="module")
def single():
    """Every case in the single-process port."""
    torch.set_num_threads(2)
    g = graph()
    return {name: run_case(name, g) for name in CASES}


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


@pytest.mark.parametrize("flag", [["--train-sharding", "hybrid"],
                                  ["--train-sharding", "halo", "--train-masked-head", "true"]])
def test_refusals_name_item_4b(flag):
    from pytextgcn_tpu_torch.experiments import flat

    with pytest.raises(SystemExit, match=r"ROADMAP\.md.*§1 item 4b"):
        flat.main(["--device", "cpu", "--train-n-devices", "2", *flag])


def test_trainer_refuses_the_masked_head_with_a_mesh():
    from pytextgcn_tpu_torch.models import GCN
    from pytextgcn_tpu_torch.parallel import Mesh
    from pytextgcn_tpu_torch.train import Trainer

    mesh = Mesh(None, 0, 2, torch.device("cpu"))
    with pytest.raises(ValueError, match=r"ROADMAP\.md §1 item 4b"):
        Trainer(GCN(10, 2, n_hidden_gcn=4), mesh=mesh, masked_head=True)
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(GCN(10, 2, n_hidden_gcn=4), device="cpu", halo=True)


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
