"""The initial parameters, made by the benchmark from ``--seed``.

One ``torch.rand`` on the run's device fills every leaf, each then scaled to
its initialiser's range, as the model kind's ``leaves`` gives them
(``benchmark/models/<kind>.py``). Both sides, the program and the
reference, start from these values.
"""

from __future__ import annotations

import importlib
import math
from typing import Dict

import torch


def model_kind(model: dict):
    """The module of the model kind ``model["kind"]``: ``benchmark/models/<kind>.py``."""
    return importlib.import_module(f"benchmark.models.{model['kind']}")


def initial_params(model: dict, n_nodes: int, n_classes: int, seed: int,
                   device: torch.device) -> Dict[str, torch.Tensor]:
    leaves = model_kind(model).leaves(model, n_nodes, n_classes)
    sizes = [math.prod(shape) for _, shape, _ in leaves]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.rand(sum(sizes), generator=gen, device=device).mul_(2.0).sub_(1.0)
    out = {}
    for (name, shape, lim), part in zip(leaves, torch.split(flat, sizes)):
        out[name] = part.view(shape).mul(lim)
    return out
