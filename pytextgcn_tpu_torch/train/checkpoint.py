"""Checkpointing: parameters, plus optimizer and generator state for a
bit-exact resume.

Port of ``pytextgcn_tpu/train/checkpoint.py``, in its file layout:
``<path>.npz`` holds the parameter tree's leaves as ``p_leaf_i`` in JAX's
flatten order (dict keys sorted, lists in order) and ``<path>.json`` holds
``meta``, so a checkpoint written by the JAX package's ``save_checkpoint``
loads here and one written here loads there. The optimizer and generator
state are torch's own (``Optimizer.state_dict()``, ``Generator.get_state()``)
serialized by ``torch.save`` into one ``torch_state`` byte array of the same
npz; the JAX loader reads only the ``p_`` and ``o_`` arrays and so passes it
by.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch


def flatten(tree) -> List[Any]:
    """Leaves of a tree of dicts and lists in JAX's ``tree_flatten`` order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in flatten(t)]
    return [tree]


def unflatten(template, leaves: List[Any]):
    """The tree of ``template``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(v) for v in t]
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template has")
    return out


def save_checkpoint(path: str, params, torch_state: Optional[Dict[str, Any]] = None,
                    meta: Optional[dict] = None) -> None:
    """Write a numpy parameter tree (and optionally torch state) to
    ``<path>.npz`` / ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {f"p_leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(flatten(params))}
    if torch_state is not None:
        buf = io.BytesIO()
        torch.save(torch_state, buf)
        payload["torch_state"] = np.frombuffer(buf.getvalue(), np.uint8)
    np.savez(path + ".npz", **payload)
    with open(path + ".json", "w") as f:
        json.dump({"has_opt_state": False, "torch_state": torch_state is not None,
                   "meta": meta or {}}, f)


def load_checkpoint(path: str, params_template) -> Tuple[Any, Optional[Dict[str, Any]]]:
    """``(params, torch_state)``: the parameter tree in ``params_template``'s
    structure (shapes are checked when it is loaded into a model) and the
    torch state, or None when the file has none (a JAX checkpoint)."""
    with np.load(path + ".npz") as z:
        keys = sorted((k for k in z.files if k.startswith("p_")),
                      key=lambda s: int(s.rsplit("_", 1)[1]))
        n_template = len(flatten(params_template))
        if len(keys) != n_template:
            raise ValueError(f"{path}.npz holds {len(keys)} parameter arrays, the "
                             f"model has {n_template}")
        params = unflatten(params_template, [z[k] for k in keys])
        state = None
        if "torch_state" in z.files:
            state = torch.load(io.BytesIO(z["torch_state"].tobytes()), map_location="cpu",
                               weights_only=True)
    return params, state


def load_meta(path: str) -> dict:
    with open(path + ".json") as f:
        return json.load(f).get("meta", {})
