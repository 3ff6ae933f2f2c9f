"""TF-IDF + MLP baselines: flat, per-level cascade, per-label ensemble.

Port of ``pytextgcn_tpu/baselines/mlp_pipeline.py`` (the reference's
MLP_flat.py / MLP_level.py / MLP_label.py + mlp_helper.py), its
data-parallel step over the ranks of a process group included. Semantics
kept:

* features: TfidfVectorizer-equivalent fit on the *train* split only
  (sklearn 'english' stopword list, max_df=0.9 — mlp_helper.py:38,88),
  val/test transformed with the fitted vocabulary/idf,
* full-batch training, Adam, mean CE, SELU+dropout MLP [256, 128],
* early stopping: patience on val macro-F1 (MLP_flat.py:95-100, the rule of
  :func:`patience_stop`),
* per-level: one-hot of the previous level appended to the sparse features —
  ground truth for train/val, *predictions* for test (MLP_level.py:112-119),
* per-label: one child model per parent class, test docs routed by the
  previous level's *predicted* labels (MLP_label.py:158-162 — unlike the
  GCN per-label eval, which routes by ground truth).

The sparse first layer runs in the CSR kernel (``use_pallas``, the default
here as everywhere in the port): per epoch one launch on the train plan
S ``[B, V]``, one on its transpose Sᵀ ``[V, B]`` for the first layer's
weight gradient, and one on the validation plan; ``_predict`` adds one on
the test plan. The data-parallel step (``train_mlp(mesh=)``) runs the same
launches on each rank's row block of the train matrix and its transpose.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from scipy import sparse as sp

from ..build.stopwords import get_stopwords
from ..build.vectorizer import CountVectorizer, TfidfTransform
from ..models.mlp import MLP, SparseMatrix
from ..parallel.sharded import Mesh, all_reduce_sum
from ..train.metrics import accuracy, macro_f1, masked_cross_entropy
from ..train.optim import resolve_optimizer
from ..train.trainer import dropout_seed
from ..utils import resolve_device

# the golden-ratio step between the ranks' dropout seeds
_RANK_STRIDE = 0x9E3779B97F4A7C15


@dataclasses.dataclass
class MlpSplits:
    x_train: sp.csr_matrix
    x_val: sp.csr_matrix
    x_test: sp.csr_matrix
    y_train: List[np.ndarray]
    y_val: List[np.ndarray]
    y_test: List[np.ndarray]


def fit_tfidf_splits(
    train_docs: Sequence[str],
    val_docs: Sequence[str],
    test_docs: Sequence[str],
    y_train: Sequence[Sequence[int]],
    y_val: Sequence[Sequence[int]],
    y_test: Sequence[Sequence[int]],
    max_df: float = 0.9,
) -> MlpSplits:
    """TF-IDF features fit on train only (mlp_helper.py:38-42)."""
    cv = CountVectorizer(min_df=1, max_df=max_df, stop_words=get_stopwords("sklearn"))
    c_train = cv.fit_transform(list(train_docs))
    tf = TfidfTransform()
    x_train = tf.fit_transform(c_train)
    x_val = tf.transform(cv.transform(list(val_docs)))
    x_test = tf.transform(cv.transform(list(test_docs)))
    return MlpSplits(
        x_train, x_val, x_test,
        [np.asarray(y) for y in y_train],
        [np.asarray(y) for y in y_val],
        [np.asarray(y) for y in y_test],
    )


def append_onehot_feats(x: sp.csr_matrix, labels: np.ndarray, n_classes: int):
    """hstack a one-hot label block onto sparse features (the reference's
    ``append_feats``, mlp_helper.py:141-151)."""
    labels = np.asarray(labels, np.int64)
    oh = sp.csr_matrix(
        (np.ones(len(labels), np.float64), (np.arange(len(labels)), labels)),
        shape=(len(labels), n_classes),
    )
    return sp.hstack([x, oh]).tocsr()


def patience_stop(f1s: Sequence[float], patience: int = 10, min_epochs: int = 30) -> bool:
    """The reference's early-stopping rule (MLP_flat.py:95-100), after epoch
    ``e = len(f1s) - 1`` (0-based): stop when ``e > min_epochs`` and
    ``e >= patience`` and each of the last ``patience`` validation F1s is
    <= the F1 of ``patience + 1`` epochs ago. No best-parameters restore."""
    e = len(f1s) - 1
    if e <= min_epochs or e < patience:
        return False
    dec = sum(f1s[-(i + 1)] <= f1s[-(patience + 1)] for i in range(patience))
    return dec >= patience


def mlp_train_step(model: MLP, opt: torch.optim.Optimizer, xs: SparseMatrix, y: torch.Tensor,
                   generator: torch.Generator) -> torch.Tensor:
    """One full-batch step: forward with dropout, mean cross-entropy,
    backward (the first layer's gradient on the transpose plan), Adam."""
    opt.zero_grad(set_to_none=True)
    logits = model(xs, train=True, generator=generator)
    loss = masked_cross_entropy(logits, y, torch.ones_like(y, dtype=torch.bool))
    loss.backward()
    opt.step()
    return loss.detach()


def rank_dropout_seed(seed: int, rank: int) -> int:
    """The dropout seed of rank ``rank`` of a data-parallel run seeded
    ``seed``: rank 0 draws the single-device stream (:func:`dropout_seed`),
    each other rank a stream of its own, none the parameters' stream (the
    JAX step folds the device index into its key)."""
    return (dropout_seed(seed) + rank * _RANK_STRIDE) % 2**63


@dataclasses.dataclass
class RowBlock:
    """Rank ``rank``'s block of ``b = ceil(n / D)`` train rows on its device:
    rows ``[rank * b, (rank + 1) * b)``, the last block padded with empty
    rows whose mask is False. ``xs`` holds the ``[b, F]`` plan and its
    ``[F, b]`` transpose."""

    xs: SparseMatrix
    y: torch.Tensor
    mask: torch.Tensor


def row_block(mesh, x: sp.csr_matrix, y, use_pallas: bool = True) -> RowBlock:
    """This rank's :class:`RowBlock` of ``x`` and ``y`` (the JAX step's
    host-side partition, ``_make_dp_step``)."""
    x = sp.csr_matrix(x)
    n, f = x.shape
    b = -(-n // mesh.world_size)
    lo, hi = min(mesh.rank * b, n), min((mesh.rank + 1) * b, n)
    block = x[lo:hi]
    indptr = np.concatenate([block.indptr, np.full(b - (hi - lo), block.indptr[-1])])
    padded = sp.csr_matrix((block.data, block.indices, indptr), shape=(b, f))
    y_b = np.zeros(b, np.int64)
    y_b[:hi - lo] = np.asarray(y)[lo:hi]
    mask = torch.zeros(b, dtype=torch.bool)
    mask[:hi - lo] = True
    dev = mesh.device
    return RowBlock(SparseMatrix.from_scipy(padded, use_pallas=use_pallas, device=dev),
                    torch.as_tensor(y_b, device=dev), mask.to(dev))


def dp_train_step(model: MLP, opt: torch.optim.Optimizer, mesh, blk: RowBlock,
                  generator: torch.Generator) -> torch.Tensor:
    """One data-parallel step: each rank backprops the cross-entropy *sum*
    over its masked rows; the loss sum, the row count and every gradient are
    summed over the ranks in one ``all_reduce`` and divided by the count, so
    the update is the full-batch gradient up to summation order and every
    rank's parameters stay equal. Returns the mean loss."""
    opt.zero_grad(set_to_none=True)
    logits = model(blk.xs, train=True, generator=generator)
    nll = -torch.log_softmax(logits, dim=-1).gather(-1, blk.y[:, None])[:, 0]
    m = blk.mask.to(logits.dtype)
    loss_sum = (nll * m).sum()
    loss_sum.backward()
    params = list(model.parameters())
    flat = torch.cat([p.grad.flatten() for p in params]
                     + [loss_sum.detach().reshape(1), m.sum().reshape(1)])
    all_reduce_sum(mesh, flat)
    denom = flat[-1].clamp(min=1.0)
    off = 0
    for p in params:
        p.grad.copy_(flat[off:off + p.numel()].view_as(p) / denom)
        off += p.numel()
    opt.step()
    return flat[-2] / denom


def train_mlp(
    x_train: sp.csr_matrix,
    y_train: np.ndarray,
    x_val: sp.csr_matrix,
    y_val: np.ndarray,
    n_classes: int,
    hidden: Sequence[int] = (256, 128),
    lr: float = 2e-3,
    dropout: float = 0.5,
    epochs: int = 500,
    seed: int = 44,
    early_stopping: bool = True,
    patience: int = 10,
    min_epochs: int = 30,
    verbose: int = 0,
    use_pallas: bool = True,
    mesh=None,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[MLP, List[Tuple[float, float]]]:
    """Full-batch MLP training; returns ``(model, history)`` with history
    one ``(train loss, val macro-F1)`` pair per epoch run.

    The parameters are drawn from ``torch.Generator().manual_seed(seed)``,
    the dropout masks from a device generator seeded ``dropout_seed(seed)``.
    The validation macro-F1 is computed on the device every epoch; with
    ``early_stopping`` the host reads it each epoch for
    :func:`patience_stop`. ``device``: None means the GPU (raises without
    one).

    ``mesh``: a ``parallel.Mesh`` (``make_mesh(axis="data")``): training
    then runs **data parallel** over its ranks, one process a rank, as the
    JAX package's ``train_mlp(mesh=)`` does over a mesh axis. Rank ``r``
    holds its :class:`RowBlock` of the train rows and steps with
    :func:`dp_train_step`; its dropout draws from the stream
    :func:`rank_dropout_seed` gives it. Every rank computes the validation
    macro-F1 on the whole validation set, so each reaches the same stopping
    decision at the same epoch and returns the same model. The trainer
    runs on the mesh's device (``device`` must be None or the same).
    """
    if mesh is not None:
        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (make_mesh(axis='data')), "
                            f"got {type(mesh).__name__}")
        if device is not None and torch.device(device) != mesh.device:
            raise ValueError(f"device {device} is not the mesh's {mesh.device}")
        device = mesh.device
    dev = resolve_device(device)
    xs_va = SparseMatrix.from_scipy(x_val, use_pallas=use_pallas, device=dev)
    y_va = torch.as_tensor(np.asarray(y_val, np.int64), device=dev)
    # a per-label member's validation child outside its train classes maps to
    # n_classes; the JAX confusion matrix's segment_sum drops those rows
    mask_va = y_va < n_classes

    model = MLP(x_train.shape[1], n_classes, list(hidden), dropout=dropout,
                generator=torch.Generator().manual_seed(seed))
    model.to(dev)
    opt = resolve_optimizer("adam", model.parameters(), lr)  # MLP_flat.py:68
    if mesh is None:
        xs_tr = SparseMatrix.from_scipy(x_train, use_pallas=use_pallas, device=dev)
        y_tr = torch.as_tensor(np.asarray(y_train, np.int64), device=dev)
        gen = torch.Generator(device=dev).manual_seed(dropout_seed(seed))
        step = lambda: mlp_train_step(model, opt, xs_tr, y_tr, gen)
    else:
        blk = row_block(mesh, x_train, y_train, use_pallas)
        gen = torch.Generator(device=dev).manual_seed(rank_dropout_seed(seed, mesh.rank))
        step = lambda: dp_train_step(model, opt, mesh, blk, gen)

    losses, f1s, f1_host = [], [], []
    for epoch in range(epochs):
        losses.append(step())
        with torch.no_grad():
            pred_va = model(xs_va).argmax(dim=-1)
            f1s.append(macro_f1(pred_va, y_va.clamp(max=n_classes - 1), mask_va, n_classes))
        if not (early_stopping or verbose > 0):
            continue
        f1_host.append(float(f1s[-1]))  # synchronizes: the stopping rule reads it
        if verbose > 0:
            print(f"[{epoch + 1}] loss: {float(losses[-1]): .3f}, val_f1: {f1_host[-1]: .3f}")
        if early_stopping and patience_stop(f1_host, patience, min_epochs):
            if verbose > 0:
                print(f"Early stopping! Validation f1 decreased for {patience} epochs!")
            break
    history = list(zip(torch.stack(losses).tolist(), torch.stack(f1s).tolist())) if losses else []
    return model, history


def _predict(model: MLP, x: sp.csr_matrix, use_pallas: bool = True) -> np.ndarray:
    dev = next(model.parameters()).device
    xs = SparseMatrix.from_scipy(x, use_pallas=use_pallas, device=dev)
    with torch.no_grad():
        return model(xs).argmax(dim=-1).cpu().numpy()


def _test_metrics(pred: np.ndarray, y: np.ndarray) -> dict:
    n = int(max(pred.max(initial=0), y.max(initial=0))) + 1
    p, t = torch.as_tensor(np.asarray(pred)), torch.as_tensor(np.asarray(y))
    m = torch.ones(len(y), dtype=torch.bool)
    return {"accuracy": float(accuracy(p, t, m)), "f1_macro": float(macro_f1(p, t, m, n))}


def mlp_flat(splits: MlpSplits, level: int, **train_kwargs) -> dict:
    """Flat MLP on one label level (MLP_flat.py). Returns the test metrics
    and ``model``, ``history`` and the test ``pred``."""
    n_classes = int(np.max(splits.y_train[level])) + 1
    model, hist = train_mlp(splits.x_train, splits.y_train[level], splits.x_val,
                            splits.y_val[level], n_classes, **train_kwargs)
    pred = _predict(model, splits.x_test, train_kwargs.get("use_pallas", True))
    out = _test_metrics(pred, splits.y_test[level])
    out.update({"model": model, "history": hist, "pred": pred})
    return out


def mlp_per_level(splits: MlpSplits, **train_kwargs) -> List[dict]:
    """Per-level cascade over all levels (MLP_level.py): GT one-hot appended
    for train/val, predicted one-hot for test."""
    results = [mlp_flat(splits, 0, **train_kwargs)]
    x_train, x_val, x_test = splits.x_train, splits.x_val, splits.x_test
    y_pred = results[0]["pred"]
    for cat in range(len(splits.y_train) - 1):
        n_prev = int(max(splits.y_train[cat].max(), splits.y_val[cat].max(),
                         splits.y_test[cat].max())) + 1
        x_train = append_onehot_feats(x_train, splits.y_train[cat], n_prev)
        x_val = append_onehot_feats(x_val, splits.y_val[cat], n_prev)
        x_test = append_onehot_feats(x_test, y_pred, n_prev)
        n_classes = int(np.max(splits.y_train[cat + 1])) + 1
        model, hist = train_mlp(x_train, splits.y_train[cat + 1], x_val,
                                splits.y_val[cat + 1], n_classes, **train_kwargs)
        pred = _predict(model, x_test, train_kwargs.get("use_pallas", True))
        res = _test_metrics(pred, splits.y_test[cat + 1])
        res.update({"model": model, "history": hist, "pred": pred})
        results.append(res)
        y_pred = pred
    return results


def mlp_per_label(splits: MlpSplits, **train_kwargs) -> List[dict]:
    """Per-label ensemble over level transitions (MLP_label.py): filter rows
    by parent class, relabel children contiguously, route test docs by the
    previous level's predictions."""
    results = [mlp_flat(splits, 0, **train_kwargs)]
    y_pred = results[0]["pred"]
    for cat in range(len(splits.y_train) - 1):
        y_tr_c, y_va_c, y_te_c = (splits.y_train[cat + 1], splits.y_val[cat + 1],
                                  splits.y_test[cat + 1])
        predictions = np.zeros_like(y_te_c)
        for label in np.unique(splits.y_train[cat]):
            tr_mask = splits.y_train[cat] == label
            va_mask = splits.y_val[cat] == label
            classes = np.unique(y_tr_c[tr_mask])
            local = np.searchsorted(classes, y_tr_c)
            local_val = np.searchsorted(classes, y_va_c)
            model, _ = train_mlp(splits.x_train[tr_mask], local[tr_mask],
                                 splits.x_val[va_mask], local_val[va_mask], len(classes),
                                 **train_kwargs)
            te_mask = y_pred == label
            if te_mask.any():
                pred_local = _predict(model, splits.x_test[te_mask],
                                      train_kwargs.get("use_pallas", True))
                predictions[te_mask] = classes[pred_local]
        res = _test_metrics(predictions, y_te_c)
        res["pred"] = predictions
        results.append(res)
        y_pred = predictions
    return results
