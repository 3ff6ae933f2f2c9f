"""The plain reference of the training epochs: the model kind's forward pass
(``benchmark/models/<kind>.py``), masked mean cross-entropy, gradients by
autograd over plain torch operations, and ``torch.optim.Adam(amsgrad=True)``'s
update written out.

Dropout draws its masks from a ``torch.Generator`` on the run's device, one
``torch.rand(shape) < keep`` for each dropout in the order the forward pass
applies them. The generator starts where the trainer's starts: seeded by the
trainer's documented rule (``dropout_seed``, copied from
``pytextgcn_tpu_torch/train/trainer.py`` at commit 313c710), or, for a step in
the timed window, at the state the trainer's generator held before it.

``precision``: ``"float64"`` is the reference. ``"tf32"`` is the control:
float32 throughout, with the operands of every dense product rounded to
TF32 (10 mantissa bits, round to nearest even), as the tensor cores round
them when TF32 is on; the sparse products stay float32. ``"float32"``: plain
float32 (a diagnostic).
"""

from __future__ import annotations

import warnings
from typing import Dict, List, Optional

import numpy as np
import torch


def dropout_seed(seed: int) -> int:
    return (seed * 0x9E3779B97F4A7C15 + 0x632BE59BD9B4E019) % 2**63


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10 mantissa bits, to nearest even."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return tf32_round(a) @ tf32_round(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = tf32_round(g)
        return g @ tf32_round(b).t(), tf32_round(a).t() @ g


class _SpMM(torch.autograd.Function):
    """``A @ x`` for a sparse ``A``; the gradient is ``A^T @ g``."""

    @staticmethod
    def forward(ctx, x, a, a_t):
        ctx.a_t = a_t
        return torch.sparse.mm(a, x)

    @staticmethod
    def backward(ctx, g):
        return torch.sparse.mm(ctx.a_t, g.contiguous()), None, None


def sparse_ahat(src, dst, w, self_w, dtype, device):
    """``(A_hat, A_hat^T)`` as sparse CSR tensors, self-loops included."""
    n = len(self_w)
    loop = np.arange(n)
    rows = np.concatenate([dst, loop])
    cols = np.concatenate([src, loop])
    vals = torch.as_tensor(np.concatenate([w, self_w]), dtype=dtype, device=device)
    idx = torch.as_tensor(np.stack([rows, cols]), device=device)

    def csr(i):
        coo = torch.sparse_coo_tensor(i, vals, (n, n), check_invariants=False).coalesce()
        with warnings.catch_warnings():
            warnings.filterwarnings("ignore", "Sparse CSR tensor support is in beta")
            return coo.to_sparse_csr()

    return csr(idx), csr(idx.flip(0))


class Model:
    """The model kind's forward pass and loss at one precision."""

    def __init__(self, kind, model: dict, a, a_t, y, precision: str):
        self.kind, self.model = kind, model
        self.a, self.a_t, self.y = a, a_t, y
        self.dtype = torch.float64 if precision == "float64" else torch.float32
        self.mm = _TF32MatMul.apply if precision == "tf32" else torch.matmul
        self.keep = 1.0 - float(model["dropout"])

    def params(self, values: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        return {k: v.detach().to(self.a.device, self.dtype).clone().requires_grad_(True)
                for k, v in values.items()}

    def loss(self, p, mask, gen: Optional[torch.Generator]):
        """Masked mean cross-entropy; dropout on where ``gen`` is given."""
        keep = self.keep

        def drop(h):
            m = torch.rand(h.shape, generator=gen, device=h.device) < keep
            return torch.where(m, h / keep, 0.0)

        logits = self.kind.forward(self.model, p, lambda x: _SpMM.apply(x, self.a, self.a_t),
                                   self.mm, drop if gen is not None else (lambda h: h))
        logp = torch.log_softmax(logits, dim=-1)
        return -logp.gather(1, self.y[:, None])[:, 0][mask].mean()


def train_steps(m: Model, adam: dict, params: Dict[str, torch.Tensor], train_mask, val_mask,
                gen: torch.Generator, steps: int) -> dict:
    """``steps`` epochs of the protocol from ``params`` (leaf name -> initial
    value) with a fresh Adam (``adam``: ``lr``, ``betas``, ``eps``,
    ``amsgrad``): per epoch a train step (forward with dropout, the loss over
    the train rows, gradients, the update) and the evaluation's validation
    loss. Returns ``loss`` and ``val_loss`` per
    epoch, and per leaf ``grad1`` (the first step's gradient norm) and
    ``delta`` (the norm of the parameters' change over the steps)."""
    p = m.params(params)
    b1, b2 = adam["betas"]
    lr, eps = float(adam["lr"]), float(adam["eps"])
    state = {k: [torch.zeros_like(v) for _ in range(3)] for k, v in p.items()}
    out: Dict[str, List] = {"loss": [], "val_loss": []}
    for t in range(1, steps + 1):
        loss = m.loss(p, train_mask, gen)
        grads = torch.autograd.grad(loss, list(p.values()))
        if t == 1:
            out["grad1"] = {k: float(g.double().norm()) for k, g in zip(p, grads)}
        with torch.no_grad():
            for (k, v), g in zip(p.items(), grads):
                mt, s, smax = state[k]
                mt.mul_(b1).add_(g, alpha=1 - b1)
                s.mul_(b2).addcmul_(g, g, value=1 - b2)
                if adam["amsgrad"]:
                    torch.maximum(smax, s, out=smax)
                else:
                    smax.copy_(s)
                denom = smax.sqrt() / ((1 - b2 ** t) ** 0.5) + eps
                v.addcdiv_(mt, denom, value=-lr / (1 - b1 ** t))
            out["loss"].append(float(loss))
            out["val_loss"].append(float(m.loss(p, val_mask, None)))
    with torch.no_grad():
        out["delta"] = {k: float((v.double() - params[k].to(v.device).double()).norm())
                        for k, v in p.items()}
    return out


def one_step(m: Model, params: Dict[str, torch.Tensor], train_mask, val_mask,
             gen: torch.Generator) -> dict:
    """From parameters ``params`` after an epoch of the window: that epoch's
    validation loss (``val_loss``), then the next train step's loss
    (``loss``) and gradient norm per leaf (``grad``)."""
    p = m.params(params)
    with torch.no_grad():
        val_loss = float(m.loss(p, val_mask, None))
    loss = m.loss(p, train_mask, gen)
    grads = torch.autograd.grad(loss, list(p.values()))
    return {"val_loss": val_loss, "loss": float(loss.detach()),
            "grad": {k: float(g.double().norm()) for k, g in zip(p, grads)}}
