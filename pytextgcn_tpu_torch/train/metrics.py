"""Classification metrics on the device.

Port of ``pytextgcn_tpu/train/metrics.py``: accuracy, confusion matrix and
macro-F1 are computed where the logits are, and only scalars leave the
device. ``macro_f1`` reproduces sklearn's ``f1_score(average='macro')``
label semantics: classes are averaged iff they appear in y_true or y_pred
(within the mask), F1 of a 0/0 class is 0.

Under the halo partition each rank holds its rows of the logits: the loss
then takes the global masked count as its denominator (each rank's term is
its part of the sum), and ``group`` sums accuracy's and the confusion
matrix's counts over the ranks, so every rank gets the single-device
metric.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F


def masked_cross_entropy(logits: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                         denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over masked nodes (torch CrossEntropyLoss with
    reduction='mean' over ``logits[mask]``). ``denom``: the masked count to
    divide by (the global one on a halo rank, :func:`global_count`)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -logp.gather(-1, y.long()[:, None])[:, 0]
    m = mask.to(logits.dtype)
    return (nll * m).sum() / (m.sum() if denom is None else denom).clamp(min=1.0)


def global_count(mask: torch.Tensor, group=None) -> torch.Tensor:
    """The masked count (f32) summed over ``group``'s ranks."""
    n = mask.float().sum()
    if group is not None:
        dist.all_reduce(n, group=group)
    return n


def accuracy(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             group=None) -> torch.Tensor:
    """Accuracy over the masked rows; with ``group``, over every rank's rows."""
    m = mask.float()
    counts = torch.stack([((pred == y).float() * m).sum(), m.sum()])
    if group is not None:
        dist.all_reduce(counts, group=group)
    return counts[0] / counts[1].clamp(min=1.0)


def confusion_matrix(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
                     n_classes: int) -> torch.Tensor:
    """[n_classes, n_classes] counts, rows = true, cols = predicted."""
    idx = y.long() * n_classes + pred.long()
    flat = torch.zeros(n_classes * n_classes, dtype=torch.int64, device=pred.device)
    flat.index_add_(0, idx, mask.long())
    return flat.reshape(n_classes, n_classes)


def macro_f1(pred: torch.Tensor, y: torch.Tensor, mask: torch.Tensor,
             n_classes: int, group=None) -> torch.Tensor:
    """Macro-F1 over the masked rows; with ``group``, over every rank's rows
    (the confusion matrices summed)."""
    cm = confusion_matrix(pred, y, mask, n_classes)
    if group is not None:
        dist.all_reduce(cm, group=group)
    cm = cm.float()
    tp = torch.diagonal(cm)
    support = cm.sum(dim=1)  # true counts per class
    predicted = cm.sum(dim=0)  # predicted counts per class
    f1 = 2 * tp / (support + predicted).clamp(min=1.0)
    present = (support > 0) | (predicted > 0)  # sklearn label union
    return (f1 * present).sum() / present.sum().clamp(min=1).float()
