"""One process playing every rank of the port's row-sharded operators
(pytextgcn_tpu_torch/parallel/): the halo ring, the sharded hybrid and the
sharded masked head, with each collective done by hand from the ranks'
local math. Shared by tests/test_torch_{hybrid,restricted}_sharded.py; it
imports no JAX."""

import torch

from pytextgcn_tpu_torch.parallel.halo import (halo_local_cotangents, halo_local_rows,
                                               halo_scatter_returned, halo_send_blocks)
from pytextgcn_tpu_torch.parallel.hybrid_sharded import (dense_pair, hot_send_block,
                                                         hybrid_dense_cotangents,
                                                         hybrid_dense_finish,
                                                         hybrid_finish_cotangent,
                                                         hybrid_hot_cotangent, unpack_hot)
from pytextgcn_tpu_torch.parallel.restricted_sharded import (restricted_finish_cotangent,
                                                             restricted_hot_cotangent,
                                                             restricted_slab)


def row_blocks(t: torch.Tensor, rows_per: int, d: int):
    """``t`` [N, H] as each rank's zero-padded ``[rows_per, H]`` block."""
    pad = torch.zeros(rows_per * d, t.shape[1], dtype=t.dtype)
    pad[:t.shape[0]] = t
    return [pad[r * rows_per:(r + 1) * rows_per] for r in range(d)]


def halo_forward(adjs, x, cd=torch.float32):
    """Every rank's rows of ``A_hat @ x`` through the halo ring."""
    a, d = adjs[0], len(adjs)
    own = [b.to(cd) for b in row_blocks(x, a.rows_per, d)]
    sends = [halo_send_blocks(adj, own[r]) for r, adj in enumerate(adjs)]
    out = []
    for r, adj in enumerate(adjs):
        recvs = [sends[(r - s - 1) % d][s] for s in range(d - 1)]
        self_term = (adj.self_w.to(cd)[:, None] * own[r]).float()
        out.append(halo_local_rows(adj, own[r], recvs, cd) + self_term)
    return torch.cat(out)[:a.n_nodes]


def halo_backward(adjs, ct, cd=torch.float32):
    """The cotangent of x from the output's ``ct``, reverse ring."""
    a, d = adjs[0], len(adjs)
    gs = row_blocks(ct, a.rows_per, d)
    local = [halo_local_cotangents(adj, gs[r], cd) for r, adj in enumerate(adjs)]
    out = []
    for r, adj in enumerate(adjs):
        returned = [local[(r + s + 1) % d][1][s] for s in range(d - 1)]
        gx = halo_scatter_returned(adj, local[r][0].clone(), returned)
        out.append(gx + (adj.self_w.to(cd)[:, None] * gs[r].to(cd)).float())
    return torch.cat(out)[:a.n_nodes]


def _x_hot(adjs, xc):
    gathered = torch.cat([hot_send_block(adj.hot_rows, xc[r]) for r, adj in enumerate(adjs)])
    return unpack_hot(adjs[0].hot_unpack, gathered)


def hybrid_forward(adjs, x, cd=torch.float32):
    """Every rank's rows of the sharded hybrid's ``A_hat @ x``: the hot
    all_gather, each rank's dense pair, the summed partial, the residual."""
    a, d = adjs[0], len(adjs)
    xc = [b.to(cd) for b in row_blocks(x, a.rows_per, d)]
    x_hot = _x_hot(adjs, xc)
    pairs = [dense_pair(adj, xc[r], x_hot) for r, adj in enumerate(adjs)]
    part_sum = sum(p[1] for p in pairs)
    dense = torch.cat([hybrid_dense_finish(adj, pairs[r][0], part_sum, x_hot)
                       for r, adj in enumerate(adjs)])[:a.n_nodes]
    return dense + halo_forward([adj.halo_res for adj in adjs], x, cd)


def hybrid_backward(adjs, ct, cd=torch.float32):
    """The cotangent of x: the summed hot cotangent, each rank's dense pair
    on it, the summed ``x_hot`` cotangent, the residual's reverse ring."""
    a, d = adjs[0], len(adjs)
    gs = row_blocks(ct, a.rows_per, d)
    g_hot = sum(hybrid_hot_cotangent(adj, gs[r]) for r, adj in enumerate(adjs))
    pairs = [hybrid_dense_cotangents(adj, gs[r], g_hot) for r, adj in enumerate(adjs)]
    g_xhot = sum(p[1] for p in pairs)
    dense = torch.cat([hybrid_finish_cotangent(adj, pairs[r][0], g_xhot, g_hot)
                       for r, adj in enumerate(adjs)])[:a.n_nodes]
    return dense + halo_backward([adj.halo_res for adj in adjs], ct, cd)


def restricted_forward(adjs, x, cd=torch.float32):
    """Every rank's rows of the sharded restricted head."""
    a, d = adjs[0], len(adjs)
    xc = [b.to(cd) for b in row_blocks(x, a.rows_per, d)]
    x_hot = _x_hot(adjs, xc)
    dense = torch.cat([restricted_slab(adj, x_hot) for adj in adjs])[:a.n_nodes]
    return dense + halo_forward([adj.halo_res for adj in adjs], x, cd)


def restricted_backward(adjs, ct, cd=torch.float32):
    a, d = adjs[0], len(adjs)
    gs = row_blocks(ct, a.rows_per, d)
    g_xhot = sum(restricted_hot_cotangent(adj, gs[r]) for r, adj in enumerate(adjs))
    dense = torch.cat([restricted_finish_cotangent(adj, g_xhot) for adj in adjs])[:a.n_nodes]
    return dense + halo_backward([adj.halo_res for adj in adjs], ct, cd)
