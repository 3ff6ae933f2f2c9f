"""The plain reference of the graph build: corpus -> TextGCN graph -> A_hat.

Written from the reference system's semantics (BeFranke/PyTextGCN
``textgcn/lib/text2graph.py`` with sklearn's ``CountVectorizer`` and
``TfidfTransformer`` defaults, and ``textgcn/lib/clib/graphbuilder.pyx``),
in numpy and plain torch, and independent of the program's code:

* tokens: lowercased ``\\w+`` runs; the vocabulary holds the terms of two or
  more characters whose document frequency lies in ``[min_df, max_df]``
  (an int is a count, a float a share of the documents), sorted;
* document-word edges: smooth-idf TF-IDF, ``tf * (ln((1 + n) / (1 + df)) + 1)``,
  each document's row scaled to unit L2 norm, in both directions;
* word-word edges: PMI over sliding windows of ``window_size`` positions of
  each document's in-vocabulary tokens. Window starts run over ``[0, L - w]``
  (one window when ``L < w``). Every position pair ``k <= l`` inside a window
  counts once per window, the diagonal included, so ``c_ii / n_windows`` is
  ``p_i``. Counted here by position pairs: a pair at distance ``d = l - k``
  lies in ``min(k, J) - max(0, l - w + 1) + 1`` windows, ``J = max(0, L - w)``
  (the program enumerates the windows instead). ``pmi = log(p_ij / (p_i
  p_j))`` in float32 with a float64 log, as the C code computes it; kept
  where ``pmi > 1e-10``, in both directions;
* ``A_hat = D^-1/2 (A + I) D^-1/2`` with ``D`` the weighted in-degree plus
  one, in float64.
"""

from __future__ import annotations

import itertools
import math
import re
from typing import Dict, Sequence

import numpy as np
import torch

_TOKEN = re.compile(r"\w+")


def _doc_count(x, n_docs: int, low: bool) -> int:
    if isinstance(x, int):
        return x
    return int(math.ceil(x * n_docs)) if low else int(x * n_docs)


def build_graph(docs: Sequence[str], y, test_idx, val_idx, graph: dict,
                device: torch.device) -> Dict[str, np.ndarray]:
    """The graph of ``docs`` under the configuration's ``graph`` settings:
    ``src``, ``dst`` (int64), ``w`` (float32) over node ids words first,
    then documents; ``n_vocab``, ``n_docs``; ``y``, ``train_mask``,
    ``val_mask``, ``test_mask``. The pair counting runs on ``device``."""
    if graph["rm_stopwords"]:
        raise NotImplementedError("the reference builds graphs without stopword removal")
    n_docs = len(docs)
    streams = [_TOKEN.findall(d.lower()) for d in docs]
    lens = np.fromiter(map(len, streams), np.int64, n_docs)
    flat = np.array(list(itertools.chain.from_iterable(streams)), dtype=str)
    terms, term_of = np.unique(flat, return_inverse=True)
    doc_of = np.repeat(np.arange(n_docs, dtype=np.int64), lens)
    pairs = np.unique(doc_of * len(terms) + term_of)
    df = np.bincount(pairs % len(terms), minlength=len(terms))
    lo = _doc_count(graph["min_df"], n_docs, True)
    hi = _doc_count(graph["max_df"], n_docs, False)
    keep = (np.char.str_len(terms) >= 2) & (df >= lo) & (df <= hi)
    n_vocab = int(keep.sum())
    vid = np.full(len(terms), -1, np.int64)
    vid[keep] = np.arange(n_vocab)

    # TF-IDF document-word edges
    tok = vid[term_of]
    in_vocab = tok >= 0
    key, tf = np.unique(doc_of[in_vocab] * n_vocab + tok[in_vocab], return_counts=True)
    d_row, w_col = key // n_vocab, key % n_vocab
    idf = np.log((1.0 + n_docs) / (1.0 + df[keep].astype(np.float64))) + 1.0
    val = tf.astype(np.float64) * idf[w_col]
    norm = np.sqrt(np.bincount(d_row, weights=val * val, minlength=n_docs))
    tfidf = (val / norm[d_row]).astype(np.float32)

    # PMI word-word edges
    ids, doc_len = tok[in_vocab], np.bincount(doc_of[in_vocab], minlength=n_docs)
    if graph["max_length"] is not None:
        first = np.concatenate([[0], np.cumsum(doc_len)[:-1]])
        pos = np.arange(len(ids)) - np.repeat(first, doc_len)
        ids = ids[pos < graph["max_length"]]
        doc_len = np.minimum(doc_len, graph["max_length"])
    a, b, c, n_windows = _pair_counts(ids, doc_len, int(graph["window_size"]), n_vocab,
                                      device)
    ww_a, ww_b, pmi = _pmi(a, b, c, n_vocab, n_windows)

    src = np.concatenate([ww_a, ww_b, d_row + n_vocab, w_col])
    dst = np.concatenate([ww_b, ww_a, w_col, d_row + n_vocab])
    w = np.concatenate([pmi, pmi, tfidf, tfidf])
    n = n_vocab + n_docs
    test_mask = np.zeros(n, bool)
    val_mask = np.zeros(n, bool)
    test_mask[np.asarray(test_idx, np.int64) + n_vocab] = True
    val_mask[np.asarray(val_idx, np.int64) + n_vocab] = True
    train_mask = ~(test_mask | val_mask)
    train_mask[:n_vocab] = False
    y_nodes = np.zeros(n, np.int64)
    y_nodes[n_vocab:] = np.asarray(y)
    return dict(src=src, dst=dst, w=w, n_vocab=n_vocab, n_docs=n_docs, y=y_nodes,
                train_mask=train_mask, val_mask=val_mask, test_mask=test_mask)


def _pair_counts(ids: np.ndarray, doc_len: np.ndarray, w: int, n_vocab: int,
                 device: torch.device):
    """Window pair counts ``(a <= b, b, count)`` and the window count."""
    n_windows = int(np.maximum(1, doc_len - w + 1).sum())
    t_ids = torch.as_tensor(ids, device=device)
    t_len = torch.as_tensor(doc_len, device=device)
    first = torch.cumsum(t_len, 0) - t_len
    doc = torch.repeat_interleave(torch.arange(len(doc_len), device=device), t_len)
    pos = torch.arange(len(ids), device=device) - first[doc]
    span = torch.clamp(t_len - w, min=0)[doc]  # J of each token's document
    keys, mults = [], []
    for d in range(w):
        ok = pos + d < t_len[doc]
        k = pos[ok]
        i = torch.nonzero(ok).flatten()
        x, z = t_ids[i], t_ids[i + d]
        mult = torch.minimum(k, span[ok]) - torch.clamp(k + d - w + 1, min=0) + 1
        keys.append(torch.minimum(x, z) * n_vocab + torch.maximum(x, z))
        mults.append(mult)
    keys, mults = torch.cat(keys), torch.cat(mults)
    uniq, inv = torch.unique(keys, return_inverse=True)
    counts = torch.zeros(len(uniq), dtype=torch.int64, device=device).index_add_(0, inv, mults)
    uniq, counts = uniq.cpu().numpy(), counts.cpu().numpy()
    return uniq // n_vocab, uniq % n_vocab, counts, n_windows


def _pmi(a: np.ndarray, b: np.ndarray, c: np.ndarray, n_vocab: int, n_windows: int):
    nw = np.float32(n_windows)
    diag = a == b
    p = np.zeros(n_vocab, np.float32)
    p[a[diag]] = c[diag].astype(np.float32) / nw
    a, b = a[~diag], b[~diag]
    p_ij = c[~diag].astype(np.float32) / nw
    with np.errstate(divide="ignore"):
        ratio = p_ij / (p[a] * p[b])
        pmi = np.log(ratio.astype(np.float64)).astype(np.float32)
    keep = pmi > np.float32(1e-10)
    return a[keep], b[keep], pmi[keep]


def normalize(g: Dict[str, np.ndarray]):
    """``(edge weights, self-loop weights)`` of ``A_hat`` in float64, for
    ``out[dst] += w x[src]`` and ``out[i] += self_w[i] x[i]``."""
    n = g["n_vocab"] + g["n_docs"]
    deg = 1.0 + np.bincount(g["dst"], weights=g["w"].astype(np.float64), minlength=n)
    inv = 1.0 / np.sqrt(deg)
    return g["w"].astype(np.float64) * inv[g["src"]] * inv[g["dst"]], inv * inv
