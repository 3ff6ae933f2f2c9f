"""The port's optimizers against optax and torch: ``'optax_amsgrad'``
(``train/optim.py::OptaxAmsgrad``) against ``optax.amsgrad`` update for
update over 25 steps (1e-6 relative to each parameter's magnitude; its bias
corrections are formed in float32 as optax forms them), and ``'adam'``
(torch's plain Adam) against ``optax.adam`` within 2e-5 of the distance
travelled (torch divides by ``sqrt(1 - b2^t)`` outside the square root,
optax inside: the two round differently, about 1e-6 relative a step;
plus 1e-6 of the parameter, its last bits). ``resolve_optimizer`` hands
out the port's :class:`Adam` for ``None``, ``'amsgrad'``,
``'torch_amsgrad'`` and ``'adam'``; on the CPU its step is torch's own."""

import copy

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pytextgcn_tpu_torch.train.optim import Adam, OptaxAmsgrad, resolve_optimizer


def _run(name, ref, lr, shapes, steps=25, seed=0):
    rng = np.random.default_rng(seed)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    params = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    opt = resolve_optimizer(name, params, lr)
    jp = [jnp.asarray(p) for p in p0]
    state = ref.init(jp)
    for _ in range(steps):
        # gradients over four decades, so the running max moves and stalls
        grads = [(rng.standard_normal(s) * 10.0 ** rng.uniform(-3, 1)).astype(np.float32)
                 for s in shapes]
        for p, g in zip(params, grads):
            p.grad = torch.tensor(g)
        opt.step()
        upd, state = ref.update([jnp.asarray(g) for g in grads], state, jp)
        jp = optax.apply_updates(jp, upd)
        yield p0, [p.detach().numpy() for p in params], [np.asarray(p) for p in jp]


@pytest.mark.parametrize("lr", [0.05, 2e-3])
def test_optax_amsgrad_matches_optax_update_for_update(lr):
    shapes = [(7, 5), (5,), (3, 4, 2)]
    assert isinstance(resolve_optimizer("optax_amsgrad", [torch.nn.Parameter(torch.ones(1))],
                                        lr), OptaxAmsgrad)
    for _, ours, theirs in _run("optax_amsgrad", optax.amsgrad(lr), lr, shapes):
        for a, b in zip(ours, theirs):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_optax_amsgrad_is_not_torch_amsgrad():
    """The two AMSGrad variants part after the first steps: optax maxes the
    bias-corrected second moment, so its steps are never larger."""
    shapes = [(6, 4)]
    a = list(_run("optax_amsgrad", optax.amsgrad(0.05), 0.05, shapes))[-1][1][0]
    t = list(_run("amsgrad", optax.amsgrad(0.05), 0.05, shapes))[-1]
    assert np.abs(a - t[1][0]).max() > 1e-3
    assert np.abs(a - t[0][0]).sum() <= np.abs(t[1][0] - t[0][0]).sum()


@pytest.mark.parametrize("lr", [0.05, 2e-3])
def test_adam_matches_optax_adam(lr):
    shapes = [(7, 5), (5,)]
    for p0, ours, theirs in _run("adam", optax.adam(lr), lr, shapes):
        for a, b, s in zip(ours, theirs, p0):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=2e-5 * np.abs(b - s).max())


def test_optax_amsgrad_state_round_trips():
    p = torch.nn.Parameter(torch.randn(4, 3))
    opt = OptaxAmsgrad([p], lr=0.01)
    p.grad = torch.randn(4, 3)
    opt.step()
    sd = copy.deepcopy(opt.state_dict())  # load_state_dict keeps same-device tensors
    q = torch.nn.Parameter(p.detach().clone())
    opt2 = OptaxAmsgrad([q], lr=0.01)
    opt2.load_state_dict(sd)
    g = torch.randn(4, 3)
    p.grad, q.grad = g, g.clone()
    opt.step()
    opt2.step()
    assert torch.equal(p, q)


@pytest.mark.parametrize("name,amsgrad", [(None, True), ("amsgrad", True),
                                          ("torch_amsgrad", True), ("adam", False)])
def test_resolve_optimizer_gives_the_port_s_adam(name, amsgrad):
    opt = resolve_optimizer(name, [torch.nn.Parameter(torch.ones(3))], 0.05)
    assert type(opt) is Adam and isinstance(opt, torch.optim.Adam)
    assert type(opt).__name__ == "Adam"  # torch's profiler range: Optimizer.step#Adam.step
    (group,) = opt.param_groups
    assert group["amsgrad"] is amsgrad and group["lr"] == 0.05
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == 0 and not group["maximize"]


def test_adam_on_the_cpu_is_torch_s_step():
    """Parameters on the CPU take ``torch.optim.Adam``'s own step and no
    launch; what the kernel computes is held to torch's foreach step on the
    card (tests/test_torch_kernels_gpu.py)."""
    rng = np.random.default_rng(0)
    p0 = [rng.standard_normal(s).astype(np.float32) for s in [(7,), (3, 5)]]
    ours = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    theirs = [torch.nn.Parameter(torch.tensor(p)) for p in p0]
    a = resolve_optimizer("amsgrad", ours, 0.05)
    b = torch.optim.Adam(theirs, lr=0.05, amsgrad=True)
    launches = Adam.launches
    for _ in range(3):
        for p, q in zip(ours, theirs):
            p.grad = torch.tensor(rng.standard_normal(p.shape).astype(np.float32))
            q.grad = p.grad.clone()
        a.step()
        b.step()
    assert Adam.launches == launches
    for p, q in zip(ours, theirs):
        assert torch.equal(p, q)
