"""The batched per-label ensemble against sequential members, step by step.

Run as ``python tests/torch_ep_kinks.py egcn:0.005 jk:0.05 jk:0.005`` (on
the card; ``--device cpu --n-docs 1500`` for a small rehearsal): for each
``model:lr``, the synthetic-amazon per-label ensemble (hidden 100, dropout
0, plain Adam, seed 44's initialization) trained twice from the same
parameters, once batched (``hierarchy/perlabel.py::ep_train_step`` on the
stacked members) and once member by member (``Trainer._train_step``), for
``--epochs`` steps. After every step it prints, for each member with more
than one class: the two runs' loss difference; the largest difference of
the model's first weight (EGCN's embedding, the JK network's first GCN
layer), where it is and that entry's gradient in both runs; the number of
activation inputs of opposite sign in the two runs (EGCN: the embedding's
SELU input ``w + b``; JK: the ReLU input after the fusion, all rows and
train rows); and how far one Adam per member, fed the batched gradients'
slices, lands from the stacked Adam. At the end, each parameter's largest
difference and its entries past 2e-4 of its largest magnitude. Shows where
a difference in the last bits of the two runs reaches a kink of the
activation and Adam carries the jump in the gradient into different steps.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(name: str, lr: float, g, cat1, cat2, epochs: int, dev) -> None:
    import torch

    from pytextgcn_tpu_torch.config import make_model, parse_config
    from pytextgcn_tpu_torch.hierarchy import perlabel as hpl
    from pytextgcn_tpu_torch.train.optim import resolve_optimizer
    from pytextgcn_tpu_torch.train.trainer import Trainer

    print(f"==== {name} lr {lr}", flush=True)
    zcfg = parse_config(["--model-n-hidden", "100", "--model-model", name,
                         "--model-dropout", "0"])
    factory = lambda: (lambda i, o, gen_=torch.Generator().manual_seed(44):
                       make_model(zcfg.model, i, o, generator=gen_))
    members = hpl._member_label_arrays(g, cat2, cat1, int(np.max(cat1)) + 1)
    sizes = [len(classes) for classes, _, _ in members]
    f_ep, f_seq = factory(), factory()
    models_ep = [f_ep(g.in_dim, c) for c in sizes]
    trainers = [Trainer(f_seq(g.in_dim, c), lr=lr, seed=44, optimizer="adam", device=dev)
                for c in sizes]
    adj, feats = trainers[0].prepare(g)
    roles = hpl._roles(models_ep[0])
    names = [n for n, _ in models_ep[0].named_parameters()]
    stacked = hpl._stack_members(models_ep, sizes, dev)
    opt = resolve_optimizer("adam", stacked, lr)
    y = torch.as_tensor(np.stack([yn for _, yn, _ in members], 1), dtype=torch.int64,
                        device=dev)
    mask = torch.as_tensor(np.stack([np.asarray(g.train_mask) & nm for _, _, nm in members],
                                    1), device=dev).float()
    gens = [torch.Generator(device=dev) for _ in sizes]  # dropout 0: never drawn
    multi = [c for c, n in enumerate(sizes) if n > 1]
    cut = lambda role, q, c, p: hpl._member(role, q, c)[..., :p.shape[-1]]
    # one Adam per member, fed the batched gradients' slices
    copies = {c: [cut(r, q, c, p).detach().clone().requires_grad_(True)
                  for r, q, p in zip(roles, stacked, trainers[c].model.parameters())]
              for c in multi}
    member_opts = {c: resolve_optimizer("adam", copies[c], lr) for c in multi}
    relu_in = {}
    if name == "jk":
        def recorder(tag):
            def act(h):
                relu_in[tag] = h.detach().clone()
                return torch.relu(h)
            return act

        models_ep[0].activation = recorder("ep")
        for c in multi:
            trainers[c].model.activation = recorder(c)
    key = names.index("embed.w" if name == "egcn" else "layers.0.w")
    for step in range(epochs):
        ep_losses = hpl.ep_train_step(stacked, opt, models_ep[0], adj, feats, y, mask, gens,
                                      sizes)
        lines = [f"step {step + 1}"]
        for c in multi:
            t = trainers[c]
            for cp, r, q, p in zip(copies[c], roles, stacked, t.model.parameters()):
                cp.grad = cut(r, q.grad, c, p).clone()
            member_opts[c].step()
            loss = float(t._train_step(adj, feats, y[:, c], mask[:, c] > 0))
            params = dict(t.model.named_parameters())
            ps = params[names[key]]
            pe = cut(roles[key], stacked[key], c, ps)
            d = (pe - ps).abs()
            i = int(d.argmax())
            ge = cut(roles[key], stacked[key].grad, c, ps).flatten()[i]
            gs = ps.grad.flatten()[i]
            if name == "jk":
                flip = (relu_in["ep"][:, c] > 0) != (relu_in[c] > 0)
                kink = (f"ReLU inputs of opposite sign {int(flip.sum())} "
                        f"({int(flip[mask[:, c] > 0].sum())} in train rows)")
            else:
                b = names.index("embed.b")
                xe = pe + cut(roles[b], stacked[b], c, params["embed.b"])
                xs = ps + params["embed.b"]
                kink = (f"SELU inputs of opposite sign {int(((xe > 0) != (xs > 0)).sum())}; "
                        f"that entry's x {float(xe.flatten()[i]):.3e} / {float(xs.flatten()[i]):.3e}")
            slice_adam = max(float((cp - cut(r, q, c, p)).abs().max())
                             for cp, r, q, p in zip(copies[c], roles, stacked,
                                                    t.model.parameters()))
            lines.append(
                f"m{c}: loss {float(ep_losses[c]) - loss:+.1e}; {names[key]} apart "
                f"{float(d.max()):.3e} at {tuple(int(v) for v in np.unravel_index(i, d.shape))}, "
                f"gradient {float(ge):.3e} batched / {float(gs):.3e} sequential; {kink}; "
                f"per-member Adam vs stacked {slice_adam:.1e}")
        print("\n  ".join(lines), flush=True)
    for c in multi:
        for j, (pn, ps) in enumerate(trainers[c].model.named_parameters()):
            d = (cut(roles[j], stacked[j], c, ps) - ps).abs()
            scale = float(ps.abs().max())
            print(f"{name} lr {lr} m{c} {pn}: apart {float(d.max()):.3e}, largest "
                  f"{scale:.3e}, {int((d > 2e-4 * scale).sum())} of {d.numel()} entries past "
                  f"2e-4 of it", flush=True)


def main(argv=None) -> None:
    import torch

    from pytextgcn_tpu_torch.config import parse_config
    from pytextgcn_tpu_torch.experiments import common, flat

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("runs", nargs="+", help="model:lr pairs, e.g. egcn:0.005 jk:0.05")
    ap.add_argument("--n-docs", type=int, default=50_000)
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    common.exact_f32()
    cfg = parse_config(["--dataset", "synthetic-amazon", "--n-docs", str(args.n_docs),
                        "--train-verbose", "0"])
    g, _ = flat.build_graph(cfg)
    _, (cat1, cat2), _, _ = common.load_corpus(cfg, levels=["Cat1", "Cat2"])
    for spec in args.runs:
        name, lr = spec.split(":")
        run(name, float(lr), g, cat1, cat2, args.epochs, torch.device(args.device))


if __name__ == "__main__":
    main()
