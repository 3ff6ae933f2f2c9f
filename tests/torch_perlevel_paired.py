"""The JAX package's per-level cascade from the port's initial parameters.

Run as ``python tests/torch_perlevel_paired.py --n-docs 3000 --seeds 42 43``
(CPU, ``JAX_PLATFORMS=cpu``): the amazon per-level protocol of
``pytextgcn_tpu_torch.experiments.protocol`` (its graph, its per-seed masks,
500 epochs, hidden 100, dropout 0.7, lr 0.05, plain Adam), trained by the
JAX package's ``train_per_level`` with each level's model starting from
the parameters the port's protocol run draws for that seed and level. The
port's own run of the same seeds (``python -m
pytextgcn_tpu_torch.experiments.protocol --device cpu --hierarchy perlevel``)
then differs from this one only in the dropout streams and the
arithmetic, and the JAX package's own run (``experiments/protocol_parity.py
--frameworks jax``) only in the initial parameters: the three together say
which of the two moves the cascade's macro-F1. Prints one line a seed and a
summary JSON (mean, population std) like the two protocol drivers.
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> None:
    import jax
    import jax.numpy as jnp
    import torch

    from pytextgcn_tpu.core.graph import TextGraph as JaxTextGraph
    from pytextgcn_tpu.hierarchy.perlevel import train_per_level
    from pytextgcn_tpu.models import GCN as JaxGCN
    from pytextgcn_tpu_torch.experiments import protocol
    from pytextgcn_tpu_torch.models import export_params

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n-docs", type=int, default=3000)
    ap.add_argument("--seeds", type=int, nargs="+", default=[42, 43, 44])
    ap.add_argument("--epochs", type=int, default=0, help="0 = the protocol's 500")
    args = ap.parse_args(argv)

    p = dict(protocol.PROTOCOLS["amazon"])
    epochs = args.epochs or p["epochs"]
    g, level_labels, n_train, n_val = protocol.build_graph(
        "amazon", args.n_docs, verbose=0, hierarchy="perlevel")

    class FromPort(JaxGCN):
        """A JAX GCN whose ``init`` returns given parameters."""

        def init(self, key):
            return jax.tree.map(jnp.asarray, self.params)

    rows = []
    for seed in args.seeds:
        gs = protocol.remask(g, "amazon", n_train, n_val, seed)
        jg = JaxTextGraph(**{f: getattr(gs, f) for f in (
            "edge_src", "edge_dst", "edge_w", "y", "train_mask", "val_mask", "test_mask",
            "n_vocab", "n_docs", "weight_symmetric")})
        # the port's factory for this seed, as protocol.run_seed makes it
        port_factory = protocol.model_factory("gcn", p, torch.Generator().manual_seed(seed))

        def factory(in_dim, out_dim):
            model = FromPort(in_dim, out_dim, n_hidden_gcn=p["n_hidden"], dropout=p["dropout"])
            model.params = export_params(port_factory(in_dim, out_dim))
            return model

        res = train_per_level(jg, level_labels, factory, lr=p["lr"], epochs=epochs, seed=seed)
        m = {k: float(v) for k, v in res["metrics"].items()}
        rows.append(m)
        print(f"[jax per-level from the port's init seed={seed}] acc {m['accuracy']:.4f} "
              f"f1 {m['f1_macro']:.4f}", flush=True)
    acc = [m["accuracy"] for m in rows]
    f1 = [m["f1_macro"] for m in rows]
    print(json.dumps({"n_docs": args.n_docs, "seeds": args.seeds, "epochs": epochs,
                      "summary": {"accuracy": [float(np.mean(acc)), float(np.std(acc))],
                                  "f1_macro": [float(np.mean(f1)), float(np.std(f1))]},
                      "runs": rows}), flush=True)


if __name__ == "__main__":
    main()
