"""Corpus loading and shared pieces of the port's experiment scripts.

Port of ``experiments/common.py``: the CSV datasets (amazon, dbpedia and
the generic csv, ``data/loaders.py``), the protocol-scale stand-ins
(synthetic-amazon / synthetic-dbpedia) and the small synthetic fallback
corpus, with the reference's split semantics and its label levels for the
hierarchy drivers.
"""

from __future__ import annotations

import contextlib
import io
import os
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..build.text2graph import Text2Graph
from ..config import ExperimentConfig, GraphConfig
from ..data.loaders import encode_labels, load_amazon, load_csv_dataset, load_dbpedia
from ..data.synthetic import protocol_corpus, synthetic_corpus


def split_blocks(n_train: int, n_val: int, n: int, rng: np.random.Generator,
                 val_split: float = 0.1):
    """``(test_idx, val_idx)`` of a corpus laid out train, [val,] test:
    test is the last block; val is the explicit block between train and
    test when ``n_val`` > 0 (flat_dbpedia.py:41-60), else a random
    ``val_split`` of train drawn from ``rng`` (flat_amazon.py:51-63)."""
    if n_val:
        return np.arange(n_train + n_val, n), np.arange(n_train, n_train + n_val)
    return np.arange(n_train, n), rng.choice(n_train, int(val_split * n_train), replace=False)


def load_corpus(cfg: ExperimentConfig, levels: Optional[Sequence[str]] = None):
    """Returns (docs, level_labels [coarse..fine], test_idx, val_idx).

    ``levels``: label level names, coarse to fine (synthetic: lvl1 lvl2;
    synthetic-amazon: Cat1 Cat2; synthetic-dbpedia: l1 l2 l3). One level or
    none gives the finest level alone; more give that many levels, top-down
    like the reference cascades (2 levels of dbpedia are l1, l2)."""
    rng = np.random.default_rng(cfg.train.seed)
    if cfg.dataset == "amazon":
        # flat_amazon.py:42-63: a random 10% of train is val, test is the
        # appended test block, labels encoded over train + test
        per_col = []
        for col in levels or [cfg.labels]:
            x_tr, y_tr, x_te, y_te = load_amazon(cfg.data_dir or "data/amazon", col)
            per_col.append((y_tr, y_te))
        docs = x_tr + x_te
        test_idx, val_idx = split_blocks(len(x_tr), 0, len(docs), rng, cfg.train.val_split)
        labels = [encode_labels(list(y_tr) + list(y_te))[0] for y_tr, y_te in per_col]
        return docs, labels, test_idx, val_idx
    if cfg.dataset == "dbpedia":
        # flat_dbpedia.py:41-60: the explicit val block between train and test
        per_col = []
        for col in levels or [cfg.labels]:
            x_tr, y_tr, x_va, y_va, x_te, y_te = load_dbpedia(
                cfg.data_dir or "data/dbpedia", col)
            per_col.append((y_tr, y_va, y_te))
        docs = x_tr + x_va + x_te
        test_idx, val_idx = split_blocks(len(x_tr), len(x_va), len(docs), rng)
        labels = [encode_labels(list(y_tr) + list(y_va) + list(y_te))[0]
                  for y_tr, y_va, y_te in per_col]
        return docs, labels, test_idx, val_idx
    if cfg.dataset == "csv":
        # train.csv / test.csv [/ val.csv] under --data-dir, any text and
        # label columns (data/loaders.py::load_csv_dataset)
        if not cfg.data_dir:
            raise SystemExit("--dataset csv requires --data-dir")
        docs, raw_levels, n_train, n_val = load_csv_dataset(
            cfg.data_dir, levels or [cfg.labels], text_col=cfg.text_col)
        # val.csv is the explicit val block (dbpedia-style), else a random
        # val fraction of train (amazon-style)
        test_idx, val_idx = split_blocks(n_train, n_val, len(docs), rng, cfg.train.val_split)
        return docs, [encode_labels(ls)[0] for ls in raw_levels], test_idx, val_idx
    if cfg.dataset in ("synthetic-amazon", "synthetic-dbpedia"):
        protocol = cfg.dataset.split("-")[1]
        n_docs = int(cfg.n_docs) or (50_000 if protocol == "amazon" else 60_000)
        docs, level_labels, n_train, n_val = protocol_corpus(protocol, n_docs=n_docs)
        # amazon's n_val is 0: its val is drawn from train
        test_idx, val_idx = split_blocks(n_train, n_val, len(docs), rng, cfg.train.val_split)
        if levels and len(levels) > 1:
            if len(levels) > len(level_labels):
                raise SystemExit(f"{cfg.dataset} has {len(level_labels)} label levels, "
                                 f"{len(levels)} requested")
            return docs, [np.asarray(l) for l in level_labels[: len(levels)]], test_idx, val_idx
        return docs, [np.asarray(level_labels[-1])], test_idx, val_idx
    if cfg.dataset == "synthetic":
        docs, child, parent = synthetic_corpus(
            n_docs=400, n_classes=6, n_parents=3, seed=cfg.train.seed
        )
        n = len(docs)
        test_idx = rng.choice(n, n // 5, replace=False)
        remaining = np.setdiff1d(np.arange(n), test_idx)
        val_idx = rng.choice(remaining, n // 10, replace=False)
        if levels and len(levels) > 1:
            return docs, [np.asarray(parent), np.asarray(child)], test_idx, val_idx
        return docs, [np.asarray(child)], test_idx, val_idx
    raise SystemExit(f"unknown dataset {cfg.dataset!r}")


def default_levels(cfg: ExperimentConfig) -> List[str]:
    """The hierarchy drivers' two levels when ``--levels`` is not given."""
    return ["lvl1", "lvl2"] if cfg.dataset == "synthetic" else ["Cat1", "Cat2"]


def pop_list_flag(argv: List[str], flag: str) -> Tuple[List[str], Optional[List[str]]]:
    """Removes ``flag`` and the values after it (up to the next ``--``
    option) from ``argv``; returns (argv, values or None)."""
    argv = list(argv)
    if flag not in argv:
        return argv, None
    i = argv.index(flag)
    j = i + 1
    while j < len(argv) and not argv[j].startswith("--"):
        j += 1
    values = argv[i + 1:j]
    del argv[i:j]
    return argv, values


def build_graph(gcfg: GraphConfig, docs, y, test_idx, val_idx, verbose: int = 1,
                device=None):
    """``Text2Graph`` with the graph knobs ``gcfg`` over the whole corpus;
    ``device`` is where device counting runs (None = the GPU), if it runs."""
    t2g = Text2Graph(
        min_df=gcfg.min_df,
        max_df=gcfg.max_df,
        window_size=gcfg.window_size,
        max_length=gcfg.max_length,
        rm_stopwords=gcfg.rm_stopwords,
        backend=gcfg.backend,
        save_path=gcfg.save_path,
        verbose=verbose,
        n_jobs=8,
        device=device,
    )
    return t2g.fit_transform(docs, y, test_idx=test_idx, val_idx=val_idx)


def trainer_kwargs(cfg: ExperimentConfig, default_optimizer: Optional[str] = None) -> dict:
    """The Trainer's aggregation and optimizer settings from the config.
    ``cfg.train.optimizer == 'default'`` leaves the optimizer to the caller
    (``default_optimizer``): amsgrad for flat runs, plain Adam for the
    hierarchy drivers, as in the reference."""
    from ..config import hybrid_f32_mode_arg, hybrid_fused_arg, hybrid_k_arg, sharding_args

    opt = cfg.train.optimizer
    kw = sharding_args(cfg.train, hybrid_k_arg(cfg.train), cfg.device)
    if "mesh" in kw:  # the trainer runs on the mesh's device
        kw["device"] = None
    return {
        "optimizer": default_optimizer if opt == "default" else opt,
        "use_pallas": cfg.train.use_pallas,
        "pallas_dtype": cfg.train.pallas_dtype,
        "device": cfg.device,
        **kw,
        "hybrid_fused": hybrid_fused_arg(cfg.train),
        "hybrid_f32_mode": hybrid_f32_mode_arg(cfg.train),
        "masked_head": cfg.train.masked_head,
        "plan_cache": cfg.train.plan_cache or None,
        "debug_checks": cfg.train.debug_checks,
    }


def exact_f32() -> None:
    """Dense products and cuDNN (the JK network's LSTM) in full f32, as the
    JAX package runs them: cuDNN would use TF32 by default."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------ ranks


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def rank_count(cfg: ExperimentConfig) -> int:
    """``--train-n-devices``, with 0 meaning every visible card (one
    process on the CPU)."""
    from ..utils import resolve_device

    if cfg.train.n_devices:
        return cfg.train.n_devices
    return torch.cuda.device_count() if resolve_device(cfg.device).type == "cuda" else 1


def over_ranks(cfg: ExperimentConfig, ep: bool = False) -> bool:
    """Whether the run spans a process group: under ``--train-sharding``,
    or, for a driver that trains the ensemble (``ep``), under ``--train-ep``
    over more than one rank (torchrun's, or :func:`rank_count`'s)."""
    from ..config import sharding_mode

    if sharding_mode(cfg.train) is not None:
        return True
    return ep and cfg.train.ep and (_under_torchrun() or rank_count(cfg) > 1)


def spawn_ranks(cfg: ExperimentConfig, target: Callable, argv: Sequence[str],
                ep: bool = False) -> bool:
    """Start the ranks ``--train-sharding`` (or, with ``ep``, ``--train-ep``)
    asks for, when this process is not one already: ``--train-n-devices N >
    1`` (0: every visible card) local processes, each calling
    ``target(rank, argv, address, N)`` (``torch.multiprocessing``, one card
    a rank), and wait for them. Returns False, starting nothing, where this
    process runs alone or is a rank (under torchrun, or in a group it has
    joined)."""
    import torch.distributed as dist

    from ..utils import resolve_device

    if not over_ranks(cfg, ep) or _under_torchrun() or dist.is_initialized():
        return False
    dev = resolve_device(cfg.device)
    n = rank_count(cfg)
    if n <= 1:
        return False
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise SystemExit(
            f"--train-n-devices {n}: {torch.cuda.device_count()} card(s) visible, and NCCL "
            "refuses two ranks on one GPU, so the experiment starts one rank a card")
    torch.multiprocessing.spawn(target, args=(list(argv), f"127.0.0.1:{_free_port()}", n),
                                nprocs=n, join=True)
    return True


def join_rank(cfg: ExperimentConfig, address: str, n: int, rank: int) -> None:
    """A spawned rank joins its group (NCCL on a card, gloo on the CPU,
    where the ranks split the cores)."""
    from ..parallel import init_distributed
    from ..utils import resolve_device

    dev = resolve_device(cfg.device)
    if dev.type == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    init_distributed(address, n, rank, device=dev)


def leave_group() -> None:
    """A spawned rank's last step: wait for every rank, then take the group
    down. A rank that exits holding it has its NCCL watchdog find rank 0's
    store gone and report an error."""
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()


@contextlib.contextmanager
def rank0_output(cfg: ExperimentConfig, ep: bool = False):
    """Where the run spans a process group (:func:`over_ranks`) join it
    (torchrun's, or one of this process alone) and silence every rank's
    standard output but rank 0's, which alone prints, writes the results
    row and saves."""
    if not over_ranks(cfg, ep):
        yield
        return
    import torch.distributed as dist

    from ..parallel import init_distributed

    init_distributed(device=cfg.device)
    if dist.get_rank() == 0:
        yield
        return
    with contextlib.redirect_stdout(io.StringIO()):
        yield
