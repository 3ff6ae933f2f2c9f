"""Dataclass configs + CLI.

Port of ``pytextgcn_tpu/config.py``: the same config tree and the same
flags, so a command line written for the JAX experiment scripts parses here. Two
differences:

* ``--train-use-pallas`` defaults to true: the port's aggregation runs in
  its hand-written CUDA kernel unless asked otherwise. The hybrid
  decomposition runs with an integer ``--train-hybrid-k`` or with 'auto'
  (the cost model on H100 constants); the default 'auto-tpu' means off
  here, as on any JAX backend that is not a TPU.
* ``--device`` picks the device: the GPU when it is not given (the run
  raises if there is none), ``cpu`` runs the kernel's plain version.

Settings a run would not honour are still parsed, and :func:`check_ported`
stops the run with a message naming ROADMAP.md instead of running
something else.
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
    # word-word counting: native (host C++) | device (torch on --device) |
    # sharded (the documents over every visible card, or over --device) |
    # oracle | auto (native, or device above PYTEXTGCN_NATIVE_TRI_BYTES)
    backend: str = "auto"
    save_path: Optional[str] = None  # directory for TGData_*.npz artifacts


@dataclasses.dataclass
class ModelConfig:
    model: str = "gcn"  # gcn | egcn | jk | mlp (the MLP runs through experiments/mlp.py)
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
    # 'auto' (the cost model on H100 constants), or 'off'/'0'; 'auto-tpu'
    # resolves to off on a GPU
    hybrid_k: str = "auto-tpu"
    # the dual kernel for the hybrid's f32 'highest' dense pair: auto | on | off
    hybrid_fused: str = "auto"
    # f32 dense-pair strategy: 'default' (= split2) | 'highest' | 'split2'
    hybrid_f32_mode: str = "default"
    # input dtype of the kernel: 'float32' or 'bfloat16' (f32 accumulation;
    # params/optimizer/loss stay f32)
    pallas_dtype: str = "float32"
    eval_every: int = 1
    # > 0: mini-batches of that many train documents on their n-hop
    # neighborhood subgraphs (Trainer.fit_minibatch); flat driver only
    batch_size: int = 0
    # finite checks after every step (loss, gradients, parameters) on the
    # on the trainer's own path (kernel, hybrid or masked head)
    debug_checks: bool = False
    # 'default' = torch Adam(amsgrad=True); or 'adam' | 'torch_amsgrad' |
    # 'optax_amsgrad' (optax's AMSGrad variant, train/optim.py)
    optimizer: str = "default"
    plan_cache: str = ""  # directory of persisted plans (ops/plan_cache.py)
    # XLA compile cache of the JAX experiment scripts; the port compiles only its
    # kernel, which is cached in the package's _build directory
    compile_cache: str = ".xla_cache"
    # the final layer aggregates into the train rows only (ops/restricted.py)
    masked_head: bool = False
    # graph partition over ranks (parallel/): off | allgather | halo | hybrid
    # (the sharded hybrid, on the halo's layout); flat experiment only
    sharding: str = "off"
    # ranks of --train-sharding and of --train-ep, one a card (0: every
    # visible card; --train-ep on the CPU: one process)
    n_devices: int = 0
    # per-label: all members in one batched step (hierarchy/perlabel.py),
    # their blocks over the ranks of --train-n-devices
    ep: bool = False
    verbose: int = 1


@dataclasses.dataclass
class ExperimentConfig:
    # synthetic | amazon | dbpedia | synthetic-amazon | synthetic-dbpedia |
    # csv (data_dir holds train.csv/test.csv[/val.csv] with a text column
    # and any label columns, data/loaders.py)
    dataset: str = "synthetic"
    data_dir: Optional[str] = None
    labels: str = "Cat2"  # amazon: Cat1/Cat2; dbpedia: l1/l2/l3; csv: any column
    text_col: Optional[str] = None  # csv: the text column (auto-detected if unset)
    # synthetic-amazon/-dbpedia corpus size (0 = protocol default:
    # 50k/60k docs, the reference datasets' scales)
    n_docs: int = 0
    result_file: Optional[str] = None
    # flat: checkpoint path of the trained model; perlabel: directory of the
    # members' checkpoints and class_mapping.json
    save_model: Optional[str] = None
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
    for obj, name in ((cfg, "data_dir"), (cfg, "text_col"), (cfg, "result_file"),
                      (cfg, "save_model"),
                      (cfg, "load_graph"), (cfg, "device"), (cfg.train, "early_stopping"),
                      (cfg.train, "compile_cache"),
                      (cfg.graph, "max_length"), (cfg.graph, "save_path")):
        if getattr(obj, name) in ("None", "none", ""):
            setattr(obj, name, None)
    if isinstance(cfg.graph.max_length, str):
        cfg.graph.max_length = int(cfg.graph.max_length)
    return cfg


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


DATASETS = ("synthetic", "amazon", "dbpedia", "synthetic-amazon", "synthetic-dbpedia", "csv")


SHARDINGS = ("off", "none", "", "allgather", "halo", "hybrid")


def sharding_mode(cfg: TrainConfig) -> Optional[str]:
    """'allgather', 'halo' or 'hybrid'; None when the graph is not sharded."""
    v = (cfg.sharding or "off").lower()
    if v not in SHARDINGS:
        raise SystemExit("--train-sharding must be 'off', 'allgather', 'halo', or 'hybrid', "
                         f"got {cfg.sharding!r}")
    return None if v in ("off", "none", "") else v


def sharding_args(cfg: TrainConfig, hybrid_k, device=None) -> dict:
    """TrainConfig.sharding/n_devices -> Trainer kwargs: ``mesh`` and
    ``halo`` (the mesh over the process group this rank has joined, or a
    group of one, ``parallel.make_mesh``) and ``hybrid_k``: ``hybrid_k``
    when not sharded, ``hybrid_k or 'auto'`` under 'hybrid' (the sharded
    hybrid, on the halo's layout), None under 'allgather' and 'halo' (the
    pure partitions; check_ported refuses an explicit K there)."""
    mode = sharding_mode(cfg)
    if mode is None:
        return {"hybrid_k": hybrid_k}
    from .parallel import make_mesh

    return {"mesh": make_mesh(cfg.n_devices or None, device=device),
            "halo": mode in ("halo", "hybrid"),
            "hybrid_k": (hybrid_k or "auto") if mode == "hybrid" else None}


def check_ported(cfg: ExperimentConfig, graph: bool = True, minibatch: bool = True,
                 sharding: bool = True) -> None:
    """Stop with a message naming ROADMAP.md when the config asks for an
    option the run would not honour. ``graph``: the config trains a graph model
    (experiments/flat.py, perlevel.py and perlabel.py, which refuse
    ``--model-model mlp``); experiments/mlp.py passes False. ``minibatch``:
    the driver can mini-batch (``--train-batch-size > 0``); the hierarchy
    and MLP experiments pass False. ``sharding``: the experiment can partition
    the graph over ranks (``--train-sharding allgather|halo|hybrid``, the
    flat experiment, as in the JAX package); the hierarchy and MLP
    experiments pass False."""
    t = cfg.train
    if graph and cfg.model.model == "mlp":
        raise SystemExit("--model-model mlp: the TF-IDF + MLP baseline takes no graph; "
                         "run it through experiments/mlp.py")
    if t.masked_head and cfg.model.model == "jk":
        # the JAX package's JK network takes no masked head either
        raise SystemExit("--train-masked-head: the JK network has no masked head "
                         "(its LSTM reads every layer's full output)")
    if cfg.dataset not in DATASETS:
        raise SystemExit(f"--dataset must be one of {', '.join(DATASETS)}, got {cfg.dataset!r}")
    if cfg.model.model not in ("gcn", "egcn", "jk", "mlp"):
        raise SystemExit(f"--model-model must be gcn, egcn, jk or mlp, got {cfg.model.model!r}")
    hybrid_k_arg(t)  # these four raise on a value they do not know
    hybrid_fused_arg(t)
    hybrid_f32_mode_arg(t)
    sharded = sharding_mode(t)
    if t.batch_size > 0:
        if not minibatch:
            raise SystemExit("--train-batch-size > 0: only the flat driver mini-batches; the "
                             "JAX package's hierarchy and MLP drivers do not either "
                             "(ROADMAP.md)")
        # options of the full graph's operator: the JAX trainer ignores them
        # when it mini-batches, the port refuses them
        unrun = [flag for flag, on in (
            (f"--train-hybrid-k {t.hybrid_k}", hybrid_k_arg(t) is not None),
            ("--train-masked-head", t.masked_head), ("--train-ep", t.ep),
            (f"--train-plan-cache {t.plan_cache}", bool(t.plan_cache)),
            (f"--train-early-stopping {t.early_stopping}", t.early_stopping is not None),
            (f"--train-sharding {t.sharding}", sharded is not None)) if on]
        if unrun:
            raise SystemExit(f"--train-batch-size > 0 does not run {', '.join(unrun)} (the "
                             "mini-batch step trains on subgraphs; ROADMAP.md)")
    if sharded is not None:
        if not sharding:
            raise SystemExit(f"--train-sharding {t.sharding}: only the flat experiment partitions "
                             "the graph, as in the JAX package (ROADMAP.md)")
        # options the partitioned run would not honour: the JAX package
        # clears a hot-set size under 'allgather' and 'halo' and reads a plan
        # cache only in the single-device operator; its sharded hybrid has no
        # split2 mode
        unrun = [flag for flag, on in (
            (f"--train-hybrid-k {t.hybrid_k} (use --train-sharding hybrid)",
             sharded != "hybrid" and hybrid_k_arg(t) is not None),
            (f"--train-plan-cache {t.plan_cache}", bool(t.plan_cache)),
            ("--train-hybrid-f32-mode split2", hybrid_f32_mode_arg(t) == "split2")) if on]
        if unrun:
            raise SystemExit(f"--train-sharding {t.sharding} does not run {', '.join(unrun)} "
                             "(refused for good: ROADMAP.md)")
        if t.n_devices == 0 and (cfg.device or "cuda").startswith("cpu"):
            raise SystemExit("--train-n-devices 0 means every visible card; on the CPU give "
                             "the number of ranks (--train-n-devices N)")


def make_model(cfg: ModelConfig, in_dim: int, out_dim: int,
               generator: Optional[torch.Generator] = None):
    from .models import EGCN, GCN, JumpingKnowledgeNetwork

    kw = dict(n_gcn=cfg.n_gcn, n_hidden_gcn=cfg.n_hidden, dropout=cfg.dropout,
              generator=generator)
    if cfg.model == "gcn":
        return GCN(in_dim, out_dim, **kw)
    if cfg.model == "egcn":
        return EGCN(in_dim, out_dim, embedding_dim=cfg.embedding_dim, **kw)
    if cfg.model == "jk":
        return JumpingKnowledgeNetwork(in_dim, out_dim, **kw)
    raise SystemExit(f"model {cfg.model!r} is not ported yet (see ROADMAP.md)")
