"""Optimizers.

Port of ``pytextgcn_tpu/train/optim.py``. The JAX package carries
``torch_amsgrad``, a clone of ``torch.optim.Adam(amsgrad=True)`` — the
reference's update rule (flat_amazon.py:89) — because optax's AMSGrad is a
different variant. Here the original is at hand: the flat default is
:class:`Adam` with ``amsgrad=True``, torch's Adam whose step on the card is
one hand-written pass (``csrc/adam.cu``) equal to torch's foreach step bit
for bit; ``"adam"`` gives it with plain Adam (the reference's hierarchy,
hyperopt and MLP scripts; it equals ``optax.adam``), and
``"optax_amsgrad"`` gives :class:`OptaxAmsgrad`, the JAX package's other
variant, kept reachable for the bisection of experiments/bisect_offset.py.
"""

from __future__ import annotations

import ctypes
from typing import Iterable, Optional, Tuple

import numpy as np
import torch

from ..ops.cuda_lib import CudaLibrary

_AMSGRAD = ("torch_amsgrad", "amsgrad")

# Adam's options whose arithmetic the kernel does not have: torch's own step
# takes them, and the kernel raises on a group that sets one
_TORCH_ONLY = ("weight_decay", "maximize", "capturable", "differentiable", "fused",
               "decoupled_weight_decay")
_TABLE = 48  # tensors a launch takes: csrc/adam.cu's kMaxTensors


class _Row(ctypes.Structure):
    """One tensor of a launch's table: ``csrc/adam.cu::AdamTensor``."""

    _fields_ = [("p", ctypes.c_void_p), ("g", ctypes.c_void_p), ("m", ctypes.c_void_p),
                ("v", ctypes.c_void_p), ("v_max", ctypes.c_void_p), ("n", ctypes.c_longlong),
                ("step_size", ctypes.c_float), ("bc2_sqrt", ctypes.c_float),
                ("w1", ctypes.c_float), ("b2", ctypes.c_float), ("w2", ctypes.c_float),
                ("eps", ctypes.c_float)]


_ADAM_LIB = CudaLibrary("adam.cu", "adam_launch",
                        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])


def _kernel_tensors(p: torch.Tensor, tensors) -> None:
    """Raise unless ``p`` is on a card and every one of ``tensors`` (``p``,
    its gradient, its state) is what the kernel takes: float32, contiguous,
    of ``p``'s shape on ``p``'s card."""
    if not p.is_cuda:
        raise ValueError(f"the fused Adam takes CUDA tensors only, got one on {p.device}")
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the fused Adam takes float32 tensors, got {t.dtype}")
        if t.device != p.device or t.shape != p.shape or not t.is_contiguous():
            raise ValueError(f"the fused Adam takes contiguous tensors of the parameter's "
                             f"shape {list(p.shape)} on its card {p.device}")


class Adam(torch.optim.Adam):
    """``torch.optim.Adam`` whose step on CUDA tensors is one launch of
    ``csrc/adam.cu`` over all of them (more only past a table of 48), in
    place of torch's eight foreach passes: the same update bit for bit,
    plain or AMSGrad as the group's ``amsgrad`` says, with torch's state
    (``step`` a CPU tensor, ``exp_avg``, ``exp_avg_sq``, ``max_exp_avg_sq``)
    and ``param_groups``, so state dicts go both ways between the two. A
    CUDA tensor the kernel does not take (another dtype, a strided view), or
    a group with an option of ``_TORCH_ONLY``, raises. Parameters on the CPU
    take torch's own step. The class keeps torch's name, so its profiler
    range stays ``Optimizer.step#Adam.step``. ``launches`` counts the
    kernel's launches in the process."""

    launches = 0

    @torch.no_grad()
    def step(self, closure=None):
        if not any(p.is_cuda for group in self.param_groups for p in group["params"]):
            return super().step(closure)
        if torch.cuda.is_current_stream_capturing():  # as torch's non-capturable Adam
            raise RuntimeError("the fused Adam's step cannot be captured: its step count "
                               "and bias corrections are the host's")
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        todo = []
        for group in self.param_groups:
            if any(group.get(k) for k in _TORCH_ONLY):
                raise ValueError(f"the fused Adam takes none of {_TORCH_ONLY}")
            for p in group["params"]:
                if p.grad is None:
                    continue
                st = self.state[p]
                keys = ("exp_avg", "exp_avg_sq", "max_exp_avg_sq")[:3 if group["amsgrad"] else 2]
                if not st:  # as torch's Adam._init_group
                    st["step"] = torch.tensor(0.0)
                    for k in keys:
                        st[k] = torch.zeros_like(p, memory_format=torch.preserve_format)
                tensors = [p, p.grad] + [st[k] for k in keys]
                _kernel_tensors(p, tensors)
                todo.append((group, st, tensors))
        tables = {}
        for group, st, tensors in todo:
            # the scalars as _multi_tensor_adam forms them, in double
            (b1, b2), lr = group["betas"], group["lr"]
            st["step"] += 1
            t = st["step"].item()
            bc1, bc2 = 1 - b1 ** t, 1 - b2 ** t
            ptrs = [x.data_ptr() for x in tensors] + [None] * (5 - len(tensors))
            row = _Row(*ptrs, tensors[0].numel(), (lr / bc1) * -1, bc2 ** 0.5, 1 - b1, b2,
                       1 - b2, group["eps"])
            tables.setdefault((tensors[0].device, group["amsgrad"]), []).append(row)
        for (device, amsgrad), rows in tables.items():
            with torch.cuda.device(device):
                stream = torch.cuda.current_stream(device).cuda_stream
                for i in range(0, len(rows), _TABLE):
                    table = (_Row * len(rows[i:i + _TABLE]))(*rows[i:i + _TABLE])
                    _ADAM_LIB.launch("adam", table, len(table), int(amsgrad), stream)
                    Adam.launches += 1
        return loss


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
    """``None``, ``"torch_amsgrad"`` or ``"amsgrad"`` -> :class:`Adam` with
    ``amsgrad=True`` and torch's defaults (betas 0.9/0.999, eps 1e-8);
    ``"adam"`` -> plain :class:`Adam`; ``"optax_amsgrad"`` ->
    :class:`OptaxAmsgrad`."""
    if optimizer is None or optimizer in _AMSGRAD:
        return Adam(params, lr=lr, amsgrad=True)
    if optimizer == "adam":
        return Adam(params, lr=lr)
    if optimizer == "optax_amsgrad":
        return OptaxAmsgrad(params, lr=lr)
    raise ValueError(f"unknown optimizer {optimizer!r}")
