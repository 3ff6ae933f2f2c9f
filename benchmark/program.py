"""The system under test: the PyTorch and CUDA port, driven through its own
entry points at a configuration's settings.

Nothing here computes what the benchmark judges: the graph is
``Text2Graph.fit_transform``'s, the operator ``Trainer.prepare``'s, and the
training epochs ``Trainer.fit``'s.
"""

from __future__ import annotations

import numpy as np
import torch

# The port's nvcc and g++ build directory is a fixed directory inside the
# checkout (pytextgcn_tpu_torch/_build), so the first run builds and later
# runs load what it built.
from pytextgcn_tpu_torch.build.text2graph import Text2Graph
from pytextgcn_tpu_torch.config import ModelConfig, make_model
from pytextgcn_tpu_torch.ops import spmm_cuda
from pytextgcn_tpu_torch.train.trainer import Trainer


def set_precision(precision: dict) -> None:
    """The configuration's precision: TF32 on or off for dense products and
    cuDNN (the protocol runs float32 with TF32 off,
    ``experiments/common.py::exact_f32``)."""
    if precision["dtype"] != "float32":
        raise NotImplementedError("the configurations run float32")
    torch.backends.cuda.matmul.allow_tf32 = bool(precision["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(precision["tf32"])


def build_graph(graph: dict, docs, y, test_idx, val_idx):
    """The TextGraph, built as the protocol builds it
    (``experiments/common.py::build_graph``), with every key of ``graph``
    passed to ``Text2Graph``."""
    t2g = Text2Graph(**graph, verbose=0, n_jobs=8)
    return t2g.fit_transform(docs, y, test_idx=test_idx, val_idx=val_idx)


def make_trainer(config: dict, g, n_classes: int, params: dict, seed: int,
                 device: torch.device) -> Trainer:
    """The configuration's model through the port's ``make_model`` (every key
    of ``model`` but ``kind`` passed to ``ModelConfig``), its parameters set
    to ``params`` (leaf name -> tensor), and its ``Trainer`` with every key
    of ``trainer`` passed as a keyword argument."""
    m = dict(config["model"])
    mcfg = ModelConfig(model=m.pop("kind"), **m)
    # drawn on the device, then overwritten with the benchmark's parameters
    with torch.device(device):
        model = make_model(mcfg, g.in_dim, n_classes,
                           torch.Generator(device=device).manual_seed(seed))
    with torch.no_grad():
        named = dict(model.named_parameters())
        if set(named) != set(params):
            raise ValueError(f"parameters {sorted(named)} != {sorted(params)}")
        for name, value in params.items():
            named[name].copy_(value)
    return Trainer(model, seed=seed, device=device, **config["trainer"])


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def csr_launches() -> int:
    """The CSR kernel's launch counter (the program's own)."""
    return spmm_cuda.spmm_csr_kernel.launches


def graph_arrays(g) -> dict:
    return dict(src=np.asarray(g.edge_src, np.int64), dst=np.asarray(g.edge_dst, np.int64),
                w=np.asarray(g.edge_w, np.float32), n_vocab=g.n_vocab, n_docs=g.n_docs)
