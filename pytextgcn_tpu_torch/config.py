"""Dataclass configs + CLI.

Port of ``pytextgcn_tpu/config.py``: the same config tree and the same
flags, so a command line written for the JAX experiment scripts parses here. Two
differences:

* ``--train-use-pallas`` defaults to true: the port's aggregation runs in
  its hand-written CUDA kernel unless asked otherwise. The hybrid
  decomposition runs with an integer ``--train-hybrid-k``; the default
  'auto-tpu' means off here, as on any JAX backend that is not a TPU.
* ``--device`` picks the device: the GPU when it is not given (the run
  raises if there is none), ``cpu`` runs the kernel's plain version.

Settings whose code is not ported yet are still parsed, and
:func:`check_ported` stops the run with a message naming ROADMAP.md
instead of running something else.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Union

import torch


@dataclasses.dataclass
class GraphConfig:
    """Text2Graph knobs (reference: text2graph.py:50-52)."""

    min_df: Union[int, float] = 5
    max_df: Union[int, float] = 1.0
    window_size: int = 20
    max_length: Optional[int] = None
    rm_stopwords: bool = True
    backend: str = "auto"  # native | oracle | auto
    save_path: Optional[str] = None  # directory for TGData_*.npz artifacts


@dataclasses.dataclass
class ModelConfig:
    model: str = "gcn"  # gcn (egcn | jk | mlp not ported yet)
    n_hidden: int = 100
    n_gcn: int = 2
    dropout: float = 0.7
    embedding_dim: int = 2000  # egcn only
    mlp_hidden: List[int] = dataclasses.field(default_factory=lambda: [256, 128])


@dataclasses.dataclass
class TrainConfig:
    epochs: int = 500
    lr: float = 0.05
    seed: int = 44
    val_split: float = 0.1
    early_stopping: Optional[str] = None  # None | reference | val_f1
    # aggregate in the hand-written CSR kernel (ops/spmm_cuda.py); false
    # runs the plain gather/index_add_ path
    use_pallas: bool = True
    # dense-hot/sparse-cold SpMM (ops/hybrid.py): an integer hot-set size,
    # or 'off'/'0'; 'auto-tpu' resolves to off on a GPU, 'auto' (the cost
    # model) is not ported yet
    hybrid_k: str = "auto-tpu"
    # the dual kernel for the hybrid's f32 'highest' dense pair: auto | on | off
    hybrid_fused: str = "auto"
    # f32 dense-pair strategy: 'default' (= split2) | 'highest' | 'split2'
    hybrid_f32_mode: str = "default"
    # input dtype of the kernel: 'float32' or 'bfloat16' (f32 accumulation;
    # params/optimizer/loss stay f32)
    pallas_dtype: str = "float32"
    eval_every: int = 1
    batch_size: int = 0  # >0 (mini-batching) is not ported yet
    debug_checks: bool = False  # not ported yet
    # 'default' = torch Adam(amsgrad=True); or 'adam' | 'torch_amsgrad'
    optimizer: str = "default"
    plan_cache: str = ""  # not ported yet
    # XLA compile cache of the JAX experiment scripts; the port compiles only its
    # kernel, which is cached in the package's _build directory
    compile_cache: str = ".xla_cache"
    masked_head: bool = False  # not ported yet
    sharding: str = "off"  # not ported yet
    n_devices: int = 0
    ep: bool = False  # not ported yet
    verbose: int = 1


@dataclasses.dataclass
class ExperimentConfig:
    # synthetic | synthetic-amazon | synthetic-dbpedia (the CSV datasets
    # amazon | dbpedia | csv are not ported yet)
    dataset: str = "synthetic"
    data_dir: Optional[str] = None
    labels: str = "Cat2"
    text_col: Optional[str] = None
    # synthetic-amazon/-dbpedia corpus size (0 = protocol default:
    # 50k/60k docs, the reference datasets' scales)
    n_docs: int = 0
    result_file: Optional[str] = None
    save_model: Optional[str] = None  # not ported yet
    load_graph: Optional[str] = None  # path to a saved TGData_*.npz artifact
    device: Optional[str] = None  # None = the GPU (raises without one)
    graph: GraphConfig = dataclasses.field(default_factory=GraphConfig)
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def _add_dataclass_args(parser: argparse.ArgumentParser, dc, prefix: str = ""):
    def int_or_float(s):
        try:
            return int(s)
        except ValueError:
            return float(s)

    for f in dataclasses.fields(dc):
        default = getattr(dc, f.name)
        if dataclasses.is_dataclass(default):
            continue  # nested config, added with its own prefix
        name = f"--{prefix}{f.name.replace('_', '-')}"
        if f.name in ("min_df", "max_df"):
            # Union[int, float]: absolute count or document fraction
            parser.add_argument(name, type=int_or_float, default=default)
            continue
        if isinstance(default, bool):
            parser.add_argument(name, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif isinstance(default, int):
            parser.add_argument(name, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(name, type=float, default=default)
        elif isinstance(default, list):
            parser.add_argument(name, type=int, nargs="+", default=default)
        else:
            parser.add_argument(name, type=str, default=default)


def build_parser(cfg: Optional[ExperimentConfig] = None) -> argparse.ArgumentParser:
    cfg = cfg or ExperimentConfig()
    p = argparse.ArgumentParser(description="pytextgcn_tpu_torch experiment")
    _add_dataclass_args(p, cfg)
    _add_dataclass_args(p, cfg.graph, "graph-")
    _add_dataclass_args(p, cfg.model, "model-")
    _add_dataclass_args(p, cfg.train, "train-")
    return p


def parse_config(argv=None, cfg: Optional[ExperimentConfig] = None) -> ExperimentConfig:
    cfg = cfg or ExperimentConfig()
    args = vars(build_parser(cfg).parse_args(argv))

    def pull(dc, prefix=""):
        for f in dataclasses.fields(dc):
            key = f"{prefix}{f.name}"
            if key in args and args[key] is not None:
                setattr(dc, f.name, args[key])

    pull(cfg)
    pull(cfg.graph, "graph_")
    pull(cfg.model, "model_")
    pull(cfg.train, "train_")
    # argparse 'None' strings back to None
    for obj, name in ((cfg, "data_dir"), (cfg, "result_file"), (cfg, "save_model"),
                      (cfg, "load_graph"), (cfg, "device"), (cfg.train, "early_stopping"),
                      (cfg.train, "compile_cache"),
                      (cfg.graph, "max_length"), (cfg.graph, "save_path")):
        if getattr(obj, name) in ("None", "none", ""):
            setattr(obj, name, None)
    if isinstance(cfg.graph.max_length, str):
        cfg.graph.max_length = int(cfg.graph.max_length)
    return cfg


def _off(v: str, *off_values: str) -> bool:
    return (v or "").lower() in off_values


def hybrid_k_arg(cfg: TrainConfig):
    """TrainConfig.hybrid_k ('off' | 'auto' | 'auto-tpu' | int string) ->
    Trainer arg. 'auto-tpu' is off: the port never runs on a TPU."""
    v = cfg.hybrid_k
    if v in (None, "off", "none", "", "auto-tpu"):
        return None
    if v == "auto":
        return "auto"
    try:
        return int(v) or None  # 0 = off, like 'off'
    except ValueError:
        raise SystemExit(
            f"--train-hybrid-k must be 'off', 'auto', 'auto-tpu', or an "
            f"integer hot-set size, got {v!r}"
        )


def hybrid_fused_arg(cfg: TrainConfig):
    """TrainConfig.hybrid_fused ('auto' | 'on' | 'off') -> Trainer arg
    (None = the default of ops/hybrid.build_hybrid_plan: off)."""
    v = (cfg.hybrid_fused or "auto").lower()
    if v in ("auto", "none", ""):
        return None
    if v in ("on", "true", "1", "yes"):
        return True
    if v in ("off", "false", "0", "no"):
        return False
    raise SystemExit(
        f"--train-hybrid-fused must be 'auto', 'on', or 'off', got {v!r}"
    )


def hybrid_f32_mode_arg(cfg: TrainConfig):
    """TrainConfig.hybrid_f32_mode ('default' | 'highest' | 'split2') ->
    Trainer arg (None = the default, 'split2')."""
    v = (cfg.hybrid_f32_mode or "default").lower()
    if v in ("default", "none", ""):
        return None
    if v in ("highest", "split2"):
        return v
    raise SystemExit(
        "--train-hybrid-f32-mode must be 'default', 'highest', or "
        f"'split2', got {v!r}"
    )


def check_ported(cfg: ExperimentConfig) -> None:
    """Stop with a message naming ROADMAP.md when the config asks for
    anything this port does not have yet."""
    t = cfg.train
    missing = []
    if cfg.dataset not in ("synthetic", "synthetic-amazon", "synthetic-dbpedia"):
        missing.append(f"--dataset {cfg.dataset}")
    if cfg.save_model:
        missing.append("--save-model")
    if cfg.model.model != "gcn":
        missing.append(f"--model-model {cfg.model.model}")
    if hybrid_k_arg(t) == "auto":  # the cost model has no H100 constants yet
        missing.append("--train-hybrid-k auto")
    hybrid_fused_arg(t)  # these two raise on a value they do not know
    hybrid_f32_mode_arg(t)
    if not _off(t.sharding, "off", "none", ""):
        missing.append(f"--train-sharding {t.sharding}")
    if t.batch_size > 0:
        missing.append("--train-batch-size > 0")
    for flag in ("masked_head", "ep", "debug_checks"):
        if getattr(t, flag):
            missing.append(f"--train-{flag.replace('_', '-')}")
    if t.plan_cache:
        missing.append("--train-plan-cache")
    if t.optimizer == "optax_amsgrad":
        missing.append("--train-optimizer optax_amsgrad")
    if missing:
        raise SystemExit(
            "not ported to pytextgcn_tpu_torch yet (see ROADMAP.md): " + ", ".join(missing)
        )


def make_model(cfg: ModelConfig, in_dim: int, out_dim: int,
               generator: Optional[torch.Generator] = None):
    from .models import GCN

    if cfg.model == "gcn":
        return GCN(in_dim, out_dim, n_gcn=cfg.n_gcn, n_hidden_gcn=cfg.n_hidden,
                   dropout=cfg.dropout, generator=generator)
    raise SystemExit(f"model {cfg.model!r} is not ported yet (see ROADMAP.md)")
