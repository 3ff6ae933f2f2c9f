"""Full-batch training engine.

Port of ``pytextgcn_tpu/train/trainer.py`` (the flat path: ``fit`` with
``eval_every`` and the 'reference' / 'val_f1' early-stopping rules,
``evaluate``, ``predict_logits``). A train step is forward, masked
cross-entropy, backward and an optimizer step; the default optimizer is
``torch.optim.Adam(amsgrad=True)``, the reference's update rule
(flat_amazon.py:89).

With ``use_pallas`` (the default here) the aggregation runs in the
hand-written CSR kernel: 2 launches per forward pass and 2 more in the
backward pass, so 4 per train step and 2 per evaluation. With
``hybrid_k`` it runs the hybrid decomposition instead, whose dual kernel
and residual CSR kernel launch that many times each.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from ..core.graph import TextGraph
from ..ops.adjacency import NormAdj
from ..ops.features import NodeFeatures
from ..utils import resolve_device
from .metrics import accuracy, macro_f1, masked_cross_entropy
from .optim import resolve_optimizer


class Trainer:
    def __init__(
        self,
        model: torch.nn.Module,
        lr: float = 0.05,
        seed: int = 0,
        optimizer: Optional[str] = None,  # None | "adam" | "torch_amsgrad"
        use_pallas: bool = True,
        pallas_dtype: str = "float32",
        device: Optional[Union[str, torch.device]] = None,
        hybrid_k: Optional[int] = None,
        hybrid_fused: Optional[bool] = None,
        hybrid_f32_mode: Optional[str] = None,
    ):
        """``seed`` seeds the dropout generator (parameters come with the
        model). ``use_pallas``: aggregate through the CSR kernel (else the
        plain gather/``index_add_`` path). ``pallas_dtype``: the kernel's
        input dtype, 'float32' or 'bfloat16' (parameters, optimizer and loss
        stay f32). ``device``: None means the GPU (raises without one).
        ``hybrid_k``/``hybrid_fused``/``hybrid_f32_mode``: the hybrid
        decomposition (ops/hybrid.py), as ``NormAdj.from_graph`` takes them."""
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.lr = lr
        self.seed = seed
        self.use_pallas = use_pallas
        self.pallas_dtype = pallas_dtype
        self.hybrid_k = hybrid_k
        self.hybrid_fused = hybrid_fused
        self.hybrid_f32_mode = hybrid_f32_mode
        self.optimizer = resolve_optimizer(optimizer, self.model.parameters(), lr)
        # one dropout stream per trainer; each fit continues it, so refits
        # draw fresh masks (the JAX trainer folds in a fit counter instead)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._adj: Optional[NormAdj] = None
        self._adj_key: Optional[tuple] = None
        self._feats: Optional[NodeFeatures] = None

    # ------------------------------------------------------------ internals

    def prepare(self, g: TextGraph):
        """Finalize the graph into the operator + feature structures. The
        operator (normalization + kernel plan) is cached by edge-array
        identity, like the JAX trainer's."""
        # the key holds the arrays themselves, so their ids cannot be reused
        key = (g.edge_src, g.edge_w, g.n_nodes)
        old = self._adj_key
        if old is None or not (old[0] is key[0] and old[1] is key[1] and old[2] == key[2]):
            self._adj = NormAdj.from_graph(
                g, use_pallas=self.use_pallas, pallas_dtype=self.pallas_dtype,
                device=self.device, hybrid_k=self.hybrid_k,
                hybrid_fused=self.hybrid_fused, hybrid_f32_mode=self.hybrid_f32_mode,
            )
            self._adj_key = key
        self._feats = NodeFeatures.from_graph(g, device=self.device)
        return self._adj, self._feats

    def _train_step(self, adj, feats, y, mask) -> torch.Tensor:
        self.optimizer.zero_grad(set_to_none=True)
        logits = self.model(adj, feats, train=True, generator=self.generator)
        loss = masked_cross_entropy(logits, y, mask)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def _eval_step(self, adj, feats, y, train_mask, val_mask, n_classes: int):
        logits = self.model(adj, feats, train=False)
        pred = logits.argmax(dim=-1)
        return {
            "val_loss": masked_cross_entropy(logits, y, val_mask),
            "val_f1": macro_f1(pred, y, val_mask, n_classes),
            "train_acc": accuracy(pred, y, train_mask),
        }

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    # ------------------------------------------------------------------ api

    def fit(
        self,
        g: TextGraph,
        epochs: int = 500,
        n_classes: Optional[int] = None,
        verbose: int = 0,
        eval_every: int = 1,
        early_stopping: Optional[str] = None,  # None | 'reference' | 'val_f1'
        patience: int = 10,
        min_epochs: int = 30,
        log_fn: Callable[[str], None] = print,
    ) -> List[Dict[str, float]]:
        """Train on the full graph; returns per-epoch history.

        ``early_stopping='reference'`` replicates flat_amazon.py:121-123
        (stop when the train loss 5 epochs ago beat the current one);
        ``'val_f1'`` is the patience scheme of MLP_flat.py:54,100-110.
        """
        if early_stopping not in (None, "reference", "val_f1"):
            raise ValueError(f"unknown early_stopping {early_stopping!r}")
        if n_classes is None:
            n_classes = int(np.max(np.asarray(g.y))) + 1
        adj, feats = self.prepare(g)
        y = self._tensor(g.y, torch.int64)
        train_mask = self._tensor(g.train_mask)
        val_mask = self._tensor(g.val_mask)

        history: List[Dict[str, float]] = []
        f1_hist: List[float] = []  # val F1 at eval points (for 'val_f1' ES)
        width = len(str(epochs))
        t0 = time.time()
        for epoch in range(epochs):
            loss = self._train_step(adj, feats, y, train_mask)
            # reading the loss synchronizes with the device: only where the
            # reference rule needs every epoch's loss, or at eval points
            is_eval = (epoch + 1) % eval_every == 0 or epoch == epochs - 1
            rec = {"loss": loss.item() if (early_stopping == "reference" or is_eval)
                   else loss}
            if is_eval:
                m = self._eval_step(adj, feats, y, train_mask, val_mask, n_classes)
                rec.update({k: float(v) for k, v in m.items()})
                if verbose > 0:
                    log_fn(
                        f"[{epoch + 1:{width}}] loss: {rec['loss']: .3f}, "
                        f"training accuracy: {rec['train_acc']: .3f}, "
                        f"val_f1: {rec['val_f1']: .3f}"
                    )
                if early_stopping == "val_f1":
                    # the reference MLP rule (MLP_flat.py:95-100): stop when
                    # each of the last `patience` F1s is <= the F1 from
                    # patience+1 evals ago (no best-params restore)
                    f1_hist.append(rec["val_f1"])
                    if epoch > min_epochs and len(f1_hist) > patience:
                        dec = sum(
                            f1_hist[-(i + 1)] <= f1_hist[-(patience + 1)]
                            for i in range(patience)
                        )
                        if dec >= patience:
                            if verbose > 0:
                                log_fn(f"Early stopping! Validation f1 decreased "
                                       f"for {dec} epochs!")
                            history.append(rec)
                            break
            history.append(rec)
            if (
                early_stopping == "reference"
                and epoch > 5
                and len(history) >= 5
                and history[-5]["loss"] < history[-1]["loss"]
            ):
                if verbose > 0:
                    log_fn("early stopping activated!")
                break
        if verbose > 0:
            log_fn(f"training took {time.time() - t0:.2f}s for {len(history)} epochs")
        return [{k: float(v) for k, v in rec.items()} for rec in history]

    @torch.no_grad()
    def predict_logits(self, g: Optional[TextGraph] = None) -> torch.Tensor:
        """Logits for all nodes (no dropout)."""
        adj, feats = (self._adj, self._feats) if g is None else self.prepare(g)
        return self.model(adj, feats, train=False)

    def evaluate(self, g: TextGraph, mask=None, n_classes: Optional[int] = None):
        """Test metrics over ``mask`` (default: the graph's test_mask)."""
        if n_classes is None:
            n_classes = int(np.max(np.asarray(g.y))) + 1
        mask = self._tensor(g.test_mask if mask is None else mask)
        y = self._tensor(g.y, torch.int64)
        pred = self.predict_logits(g).argmax(dim=-1)
        return {
            "accuracy": float(accuracy(pred, y, mask)),
            "f1_macro": float(macro_f1(pred, y, mask, n_classes)),
        }
