"""Persistent cache of the aggregation plans.

Port of ``pytextgcn_tpu/ops/plan_cache.py``. Building a plan is host work
that every fresh process pays again: the CSR plans' sorts and segment
cuts (about 3 s on the 50k-document synthetic-amazon graph), the hybrid's
hot set, symmetry audit, residual plans and, under ``hybrid_k='auto'``,
the cost model's pass over every candidate K. This module stores the
host-built parts in an ``.npz`` keyed by a fingerprint of the edge arrays
and every build parameter:

* a CSR plan (:class:`~.spmm_cuda.SpmmPlan`): its forward and transpose
  :class:`~.spmm_cuda.CsrPlan` arrays;
* a hybrid plan (:class:`~.hybrid.HybridPlan`): its hot set, its residual
  (CSR plans or segment arrays) and its metadata. The dense block D (up to
  GBs) is not stored: the load rebuilds it from the edges with the same
  function the cold build uses (:func:`~.hybrid.dense_blocks`), which gives
  the same bits.

Layout: ``<cache_dir>/plan-<key>.npz``. The key covers the fingerprint,
the plan's kind and parameters and the format version, and for
``hybrid_k='auto'`` the cost model's version too, so that a recalibration
never serves a stale K.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Optional, Union

import numpy as np
import torch

from .hybrid import COST_MODEL_VERSION, HybridPlan, dense_blocks
from .spmm_cuda import CsrPlan, SpmmPlan

_FORMAT_VERSION = 1
_CSR_FIELDS = ("row_ptr", "pairs", "seg_ptr", "seg_row", "seg_slot", "split_row", "split_ptr")


def graph_fingerprint(src: np.ndarray, dst: np.ndarray, w: np.ndarray, n_nodes: int) -> str:
    """Blake2b over the raw edge arrays (the unnormalized weights: the plan
    is a function of them and ``n_nodes``)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(np.int64(n_nodes).tobytes())
    for a in (src, dst, w):
        a = np.ascontiguousarray(a)
        h.update(str(a.dtype).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def plan_key(fingerprint: str, **params) -> str:
    """The cache key of a plan built with ``params`` on the graph of
    ``fingerprint``; 'auto' hybrid keys fold in ``COST_MODEL_VERSION``."""
    items = sorted(params.items())
    if params.get("hybrid_k") == "auto":
        items.append(("cost_model", COST_MODEL_VERSION))
    h = hashlib.blake2b(digest_size=12)
    h.update(repr((_FORMAT_VERSION, fingerprint, items)).encode())
    return h.hexdigest()


def _path(cache_dir: str, key: str) -> str:
    return os.path.join(cache_dir, f"plan-{key}.npz")


def _csr_arrays(csr: CsrPlan, prefix: str) -> dict:
    out = {f"{prefix}_{f}": getattr(csr, f).cpu().numpy() for f in _CSR_FIELDS}
    out[f"{prefix}_meta"] = np.asarray([csr.n_rows, csr.n_cols, csr.n_partials], np.int64)
    return out


def _csr_from(z, prefix: str, device: torch.device) -> CsrPlan:
    n_rows, n_cols, n_partials = (int(v) for v in z[f"{prefix}_meta"])
    return CsrPlan(**{f: torch.as_tensor(z[f"{prefix}_{f}"], device=device)
                      for f in _CSR_FIELDS},
                   n_rows=n_rows, n_cols=n_cols, n_partials=n_partials)


def _spmm_arrays(plan: SpmmPlan, prefix: str) -> dict:
    return {**_csr_arrays(plan.fwd, f"{prefix}f"), **_csr_arrays(plan.bwd, f"{prefix}b"),
            f"{prefix}_dtype": np.asarray(plan.compute_dtype)}


def _spmm_from(z, prefix: str, device: torch.device) -> SpmmPlan:
    return SpmmPlan(fwd=_csr_from(z, f"{prefix}f", device),
                    bwd=_csr_from(z, f"{prefix}b", device),
                    compute_dtype=str(z[f"{prefix}_dtype"]))


def save_plan(cache_dir: str, key: str, plan: Union[SpmmPlan, HybridPlan]) -> str:
    """Write ``plan``'s host-built parts; returns the file's path."""
    os.makedirs(cache_dir, exist_ok=True)
    if isinstance(plan, SpmmPlan):
        arrays = {"kind": np.asarray("csr"), **_spmm_arrays(plan, "p")}
    else:
        arrays = {
            "kind": np.asarray("hybrid"),
            "hot_ids": plan.hot_ids.cpu().numpy(),
            "meta_i": np.asarray([plan.n_nodes, plan.k, int(plan.fused), plan.n_resid,
                                  int(plan.d_lo is not None)], np.int64),
            "predicted_spmm_ns": np.asarray(plan.predicted_spmm_ns, np.float64),
            "compute_dtype": np.asarray(plan.compute_dtype),
        }
        if plan.res is not None:
            arrays.update(_spmm_arrays(plan.res, "r"))
        if plan.seg_src is not None:
            arrays.update(seg_src=plan.seg_src.cpu().numpy(),
                          seg_dst=plan.seg_dst.cpu().numpy(),
                          seg_w=plan.seg_w.cpu().numpy())
    path = _path(cache_dir, key)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)  # uncompressed: the load's speed is the point
    os.replace(tmp, path)
    return path


def load_plan(cache_dir: str, key: str, src, dst, norm_w,
              device: torch.device) -> Optional[Union[SpmmPlan, HybridPlan]]:
    """The plan saved under ``key`` on ``device`` (a hybrid plan's dense
    block rebuilt from the normalized edges), or None on a miss."""
    path = _path(cache_dir, key)
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if str(z["kind"]) == "csr":
            return _spmm_from(z, "p", device)
        n_nodes, k, fused, n_resid, split = (int(v) for v in z["meta_i"])
        compute_dtype = str(z["compute_dtype"])
        hot_ids = z["hot_ids"]
        res = _spmm_from(z, "r", device) if "r_dtype" in z else None
        seg = {name: torch.as_tensor(z[name], device=device)
               for name in ("seg_src", "seg_dst", "seg_w") if name in z}
        predicted = float(z["predicted_spmm_ns"])
    d_full, d_lo, a_hh = dense_blocks(
        np.asarray(src, np.int64), np.asarray(dst, np.int64),
        np.asarray(norm_w, np.float32), n_nodes, hot_ids, compute_dtype, bool(split), device)
    return HybridPlan(hot_ids=torch.as_tensor(hot_ids, device=device), d_full=d_full,
                      d_lo=d_lo, a_hh=a_hh, res=res, n_nodes=n_nodes, k=k,
                      compute_dtype=compute_dtype, fused=bool(fused), n_resid=n_resid,
                      predicted_spmm_ns=predicted, **seg)


def load_or_build(cache_dir: Optional[str], g, src, dst, norm_w, device: torch.device,
                  build: Callable[[], Optional[Union[SpmmPlan, HybridPlan]]], **params):
    """The plan ``build()`` makes, through the cache in ``cache_dir`` (None:
    no cache). ``params`` are everything ``build`` depends on besides the
    graph; the fingerprint covers the raw edge arrays of ``g``, so
    hierarchy pipelines that only swap labels and masks hit one entry. A
    ``build`` that returns None (the segment path) is not cached."""
    if cache_dir is None:
        return build()
    fp = graph_fingerprint(np.asarray(g.edge_src), np.asarray(g.edge_dst),
                           np.asarray(g.edge_w), g.n_nodes)
    key = plan_key(fp, **params)
    plan = load_plan(cache_dir, key, src, dst, norm_w, device)
    if plan is None:
        plan = build()
        if plan is not None:
            save_plan(cache_dir, key, plan)
    return plan
