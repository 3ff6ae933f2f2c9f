"""Optimizers.

Port of ``pytextgcn_tpu/train/optim.py``. The JAX package carries
``torch_amsgrad``, a clone of ``torch.optim.Adam(amsgrad=True)`` — the
reference's update rule (flat_amazon.py:89) — because optax's AMSGrad is a
different variant. Here the original is at hand, so the flat default is
``torch.optim.Adam(amsgrad=True)`` itself; ``"adam"`` gives plain Adam
(the reference's hierarchy, hyperopt and MLP scripts; it equals
``optax.adam``), and ``"optax_amsgrad"`` gives :class:`OptaxAmsgrad`, the
JAX package's other variant, kept reachable for the bisection of
experiments/bisect_offset.py.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

import numpy as np
import torch

_AMSGRAD = ("torch_amsgrad", "amsgrad")


def _f32_bias_correction(beta: float, t: int) -> float:
    """``1 - beta**t`` as optax forms it: ``beta`` rounded to float32, the
    power rounded to float32 (XLA's f32 ``pow`` gives the correctly rounded
    value), the difference in float32."""
    power = np.float32(float(np.float32(beta)) ** t)
    return float(np.float32(1.0) - power)


class OptaxAmsgrad(torch.optim.Optimizer):
    """``optax.amsgrad(lr, b1, b2, eps)`` update for update.

    optax keeps the running max over the **bias-corrected** second moment,
    where torch's ``Adam(amsgrad=True)`` maxes the uncorrected one and
    divides by ``sqrt(1 - b2^t)`` afresh each step (the JAX package's
    train/optim.py docstring sets out the difference: optax's denominator is
    never smaller, so its steps are). Per parameter::

        mu    = (1 - b1) g + b1 mu
        nu    = (1 - b2) g^2 + b2 nu
        nu_max = max(nu_max, nu / (1 - b2^t))
        p    += -lr * (mu / (1 - b1^t)) / (sqrt(nu_max) + eps)

    with the bias corrections in float32, as optax computes them.
    """

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 betas: Tuple[float, float] = (0.9, 0.999), eps: float = 1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            b1, b2 = group["betas"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                if not st:
                    st["step"] = torch.tensor(0.0)  # on the CPU, as torch's Adam keeps it
                    for k in ("mu", "nu", "nu_max"):
                        st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
                st["step"] += 1
                t = int(st["step"])
                g = p.grad
                st["mu"].mul_(b1).add_(g * (1 - b1))
                st["nu"].mul_(b2).add_(g * g * (1 - b2))
                torch.maximum(st["nu_max"], st["nu"] / _f32_bias_correction(b2, t),
                              out=st["nu_max"])
                upd = (st["mu"] / _f32_bias_correction(b1, t)) / (st["nu_max"].sqrt()
                                                                 + group["eps"])
                p.add_(upd * -group["lr"])
        return loss


def resolve_optimizer(optimizer: Optional[str], params: Iterable[torch.nn.Parameter],
                      lr: float) -> torch.optim.Optimizer:
    """``None``, ``"torch_amsgrad"`` or ``"amsgrad"`` -> ``Adam(amsgrad=True)``
    with torch defaults (betas 0.9/0.999, eps 1e-8); ``"adam"`` -> plain
    ``Adam``; ``"optax_amsgrad"`` -> :class:`OptaxAmsgrad`."""
    if optimizer is None or optimizer in _AMSGRAD:
        return torch.optim.Adam(params, lr=lr, amsgrad=True)
    if optimizer == "adam":
        return torch.optim.Adam(params, lr=lr)
    if optimizer == "optax_amsgrad":
        return OptaxAmsgrad(params, lr=lr)
    raise ValueError(f"unknown optimizer {optimizer!r}")
