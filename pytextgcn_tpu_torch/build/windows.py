"""Sliding-window PMI word-word edge construction (host parts).

The port of ``pytextgcn_tpu/build/windows.py``: the exact numpy oracle, the
PMI finalization, the dispatch to the native C++ counting kernel
(``native/graphbuilder.cpp``) and the sparse device counting path
(:func:`word_word_edges_device`: torch sort/unique on the card, for
vocabularies whose packed count triangle is too large for the host) and
its document-sharded form over several devices
(:func:`word_word_edges_sharded`).

Reference semantics (textgcn/lib/clib/graphbuilder.pyx):

* window starts ``j in [0, seq_len - window_size]``; a window whose last slot
  is padding ends the document's windows unless ``j == 0``
  (graphbuilder.pyx:96-100),
* pair counts accumulate for all ``k <= l`` positions inside the window whose
  tokens are both non-padding (graphbuilder.pyx:103-113),
* diagonal counts double as unigram window counts; ``p_i = c_ii / n_windows``
  (graphbuilder.pyx:146-147),
* ``pmi = log(p_ij / (p_i * p_j))``, computed in float32 with a float64 log
  exactly like the C code (graphbuilder.pyx:156-161), kept iff
  ``pmi > 1e-10``,
* both edge directions emitted, interleaved in ascending ``(i, j)`` order
  (graphbuilder.pyx:181-191); no self-loops.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..utils import resolve_device
from .native_bridge import native_word_word_edges


def tri_diag_index(row: np.ndarray, col: np.ndarray, n: int) -> np.ndarray:
    """Index into a packed upper-triangular (incl. diagonal) array, matching
    ``SymMat_Diag_idx`` (graphbuilder.pyx:214-226)."""
    r = np.minimum(row, col).astype(np.int64)
    c = np.maximum(row, col).astype(np.int64)
    return r * n + c - ((r + 1) * r) // 2


def sliding_window_counts(tokens: np.ndarray, n_vocab: int, window_size: int):
    """Packed triangular pair counts + window count, exact clone of the
    reference's ``sliding_window`` (graphbuilder.pyx:71-115) including its
    break rules. Python-loop implementation — use only for tests/oracles.

    Returns: (c_ij uint32 [V(V+1)/2], n_windows int)
    """
    n_docs, seq_len = tokens.shape
    if seq_len < window_size:
        # The C code would loop over an underflowed unsigned range here; the
        # safe behavior is defined instead: pad to one full window (j == 0).
        pad = np.full((n_docs, window_size - seq_len), -1, dtype=tokens.dtype)
        tokens = np.concatenate([tokens, pad], axis=1)
        seq_len = window_size
    size = (n_vocab * (n_vocab + 1)) // 2
    c_ij = np.zeros(size, dtype=np.uint32)
    n_windows = 0
    for i in range(n_docs):
        doc = tokens[i]
        for j in range(seq_len - window_size + 1):
            if doc[j + window_size - 1] == -1 and j != 0:
                break
            n_windows += 1
            for k in range(j, j + window_size):
                if k >= seq_len or doc[k] == -1:
                    break
                for l in range(k, j + window_size):
                    if l >= seq_len or doc[l] == -1:
                        break
                    c_ij[tri_diag_index(doc[k], doc[l], n_vocab)] += 1
    return c_ij, n_windows


def pmi_edges_from_pairs(
    pair_a: np.ndarray,
    pair_b: np.ndarray,
    counts: np.ndarray,
    n_vocab: int,
    n_windows: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """Sparse PMI pass over unique pairs ``a <= b`` with their counts.

    Float32 arithmetic with float64 log replicates the C float semantics of
    ``edges_from_counts`` (graphbuilder.pyx:146-166). Pairs must be sorted
    lexicographically so emission order matches the reference's row-major
    upper-triangle scan (graphbuilder.pyx:181-191).

    Returns (coo int32 [E, 2], weights float32 [E]) with both directions
    interleaved: (i, j), (j, i), ...
    """
    nw = np.float32(n_windows)
    diag = pair_a == pair_b
    p = np.zeros(n_vocab, dtype=np.float32)
    p[pair_a[diag]] = counts[diag].astype(np.float32) / nw

    a = pair_a[~diag]
    b = pair_b[~diag]
    p_ij = counts[~diag].astype(np.float32) / nw
    denom = p[a] * p[b]
    ok = (p_ij > 0) & (p[a] > 0) & (p[b] > 0)
    ratio = np.where(ok, p_ij / np.where(denom == 0, 1, denom), 1).astype(np.float32)
    pmi = np.log(ratio.astype(np.float64)).astype(np.float32)
    keep = ok & (pmi > np.float32(1e-10))

    a, b, w = a[keep], b[keep], pmi[keep]
    e = a.shape[0]
    coo = np.empty((2 * e, 2), dtype=np.int32)
    weights = np.empty(2 * e, dtype=np.float32)
    coo[0::2, 0] = a
    coo[0::2, 1] = b
    coo[1::2, 0] = b
    coo[1::2, 1] = a
    weights[0::2] = w
    weights[1::2] = w
    return coo, weights


# --------------------------------------------------------------------------
# on-device counting: pair enumeration + one-key sort/unique, merged on device
# --------------------------------------------------------------------------


def _count_chunk(chunk: torch.Tensor, window_size: int, n_vocab: int):
    """Unique normalized pairs of one chunk of documents with their counts.

    ``chunk``: int32 ``[D, S]`` on the device, padded with -1 (a contiguous
    suffix), ``S >= window_size``. Returns ``(keys, counts, n_windows)``:
    the sorted unique keys ``lo * n_vocab + hi`` (``lo <= hi``), their int64
    counts and the number of valid windows, every row's first one included,
    as a 0-d tensor."""
    w = window_size
    # window validity with the j > 0 break rule (graphbuilder.pyx:96-100):
    # a window whose last slot is padding ends the row, but the first
    # window always counts
    tail_valid = chunk[:, w - 1:] != -1  # [D, n_pos]
    tail_valid[:, 0] = True
    vw = tail_valid.to(torch.int32).cumprod(dim=1).bool()
    n_windows = vw.sum()

    # intra-window pairs k <= l of every window
    k_off, l_off = (torch.as_tensor(t, device=chunk.device) for t in np.triu_indices(w))
    win = chunk.unfold(1, w, 1)  # [D, n_pos, w], a view
    a = win[:, :, k_off]  # [D, n_pos, n_pairs]
    b = win[:, :, l_off]
    valid = vw[:, :, None] & (a != -1) & (b != -1)
    lo = torch.minimum(a, b)[valid].long()
    hi = torch.maximum(a, b)[valid].long()
    # one int64 key sorts (lo, hi) lexicographically because hi < n_vocab
    keys, counts = torch.unique(lo * n_vocab + hi, sorted=True, return_counts=True)
    return keys, counts, n_windows


def _merge_keyed(keys: torch.Tensor, counts: torch.Tensor,
                 more_keys: torch.Tensor, more_counts: torch.Tensor):
    """The union of two sorted unique key lists, counts of equal keys summed
    in int64 (the merged totals can pass 2^31 on large corpora, as the JAX
    merge widens them for)."""
    keys, inverse = torch.unique(torch.cat([keys, more_keys]), sorted=True,
                                 return_inverse=True)
    summed = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    summed.index_add_(0, inverse, torch.cat([counts, more_counts]))
    return keys, summed


def _length_buckets(lengths: np.ndarray, min_len: int):
    """Bucket document lengths to limit padded work: next power of two
    (>= min_len), clamped to the max length."""
    caps = []
    cap = max(min_len, 16)
    max_len = int(lengths.max()) if lengths.size else min_len
    while cap < max_len:
        caps.append(cap)
        cap *= 2
    caps.append(max(cap, max_len))
    return caps


def _iter_chunks(tokens: np.ndarray, window_size: int, chunk_pair_budget: int):
    """Yield length-bucketed document chunks ``(chunk, n_real)``, each
    padded with filler rows of -1 to a power-of-two row count and holding
    at most ``chunk_pair_budget`` window pairs (one document at least)."""
    n_docs, seq_len = tokens.shape
    lengths = (tokens != -1).sum(axis=1)
    n_pairs = window_size * (window_size + 1) // 2
    order = np.argsort(lengths, kind="stable")
    caps = _length_buckets(lengths, window_size)
    lo_len = -1
    for cap in caps:
        sel = order[(lengths[order] > lo_len) & (lengths[order] <= cap)]
        lo_len = cap
        if sel.size == 0:
            continue
        s = max(cap, window_size)
        n_pos = s - window_size + 1
        per_doc = n_pos * n_pairs
        docs_per_chunk = max(1, chunk_pair_budget // per_doc)
        # a power of two, and never a small bucket padded up to a huge chunk
        docs_per_chunk = min(docs_per_chunk, 2 * sel.size - 1)
        docs_per_chunk = 1 << int(np.floor(np.log2(docs_per_chunk)))
        for off in range(0, sel.size, docs_per_chunk):
            idx = sel[off : off + docs_per_chunk]
            chunk = np.full((docs_per_chunk, s), -1, dtype=np.int32)
            ncols = min(s, seq_len)
            chunk[: idx.size, :ncols] = tokens[idx][:, :ncols]
            yield chunk, idx.size


def _check_tokens(tokens: np.ndarray, n_vocab: int) -> np.ndarray:
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    if tokens.size and (tokens.min() < -1 or tokens.max() >= n_vocab):
        raise ValueError(f"token ids must lie in [0, {n_vocab}) (padding -1)")
    return tokens


def _count_on(tokens: np.ndarray, n_vocab: int, window_size: int, chunk_pair_budget: int,
              device: torch.device):
    """Every chunk of ``tokens`` counted on ``device``, one at a time, each
    merged at once into the running unique list there. Returns the sorted
    unique keys and their counts (on ``device``) and the window count."""
    keys = torch.zeros(0, dtype=torch.int64, device=device)
    counts = torch.zeros(0, dtype=torch.int64, device=device)
    n_windows = torch.zeros((), dtype=torch.int64, device=device)
    n_filler = 0
    for chunk, n_real in _iter_chunks(tokens, window_size, chunk_pair_budget):
        ck, cc, cw = _count_chunk(torch.as_tensor(chunk).to(device), window_size, n_vocab)
        keys, counts = _merge_keyed(keys, counts, ck, cc)
        n_windows += cw
        n_filler += chunk.shape[0] - n_real
    # every row, real or filler, counts its first window: take the fillers'
    return keys, counts, int(n_windows) - n_filler


def _pmi_of_keys(keys: torch.Tensor, counts: torch.Tensor, n_vocab: int, n_windows: int):
    keys, counts = keys.cpu().numpy(), counts.cpu().numpy()
    a = (keys // n_vocab).astype(np.int32)
    b = (keys % n_vocab).astype(np.int32)
    coo, wgt = pmi_edges_from_pairs(a, b, counts, n_vocab, n_windows)
    return coo, wgt, n_windows


def word_word_edges_device(
    tokens: np.ndarray,
    n_vocab: int,
    window_size: int = 20,
    chunk_pair_budget: int = 1 << 24,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Sparse window counting on ``device`` (None = the GPU), length-bucketed
    and chunked; memory scales with the distinct co-occurring pairs, not V^2.

    Each chunk's pairs are counted by one sort/unique on int64 keys and
    merged at once into the running unique list on the device, so the
    device holds the merged list and one chunk's buffers, whatever the
    number of chunks. The merged ``(a, b, count)`` comes to the host once;
    PMI runs there (:func:`pmi_edges_from_pairs`), so the weights equal the
    native kernel's bit for bit. ``chunk_pair_budget`` bounds a chunk's
    window pairs (its buffers).

    tokens: int32 [n_docs, seq_len] padded with -1 (contiguous suffix).
    Returns (coo [E,2] int32, weights [E] float32, n_windows).
    """
    tokens = _check_tokens(tokens, n_vocab)
    if tokens.shape[0] == 0:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.float32), 0
    keys, counts, n_windows = _count_on(tokens, n_vocab, window_size, chunk_pair_budget,
                                        resolve_device(device))
    return _pmi_of_keys(keys, counts, n_vocab, n_windows)


def sharded_devices(device: Optional[Union[str, torch.device]] = None) -> List[torch.device]:
    """The devices document-sharded counting spreads over: every visible
    card for None or ``'cuda'`` (raises without one), else the one device
    named (``'cuda:1'``, ``'cpu'``)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def word_word_edges_sharded(
    tokens: np.ndarray,
    n_vocab: int,
    window_size: int = 20,
    devices: Optional[Sequence[Union[str, torch.device]]] = None,
    chunk_pair_budget: int = 1 << 24,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Document-sharded window counting over several devices of this
    process (port of the JAX package's ``word_word_edges_sharded``).

    Windows never cross a document (graphbuilder.pyx:96: a window starts
    inside one document's token row), so sharding the documents is exact:
    the documents are cut into ``len(devices)`` contiguous shards at
    ``np.linspace(0, n_docs, D + 1)``, each device counts its shard's
    chunks (:func:`_iter_chunks`) one at a time, merging each into its
    running unique-pair list as :func:`word_word_edges_device` does, so a
    device holds its merged list and one chunk's buffers. The host merges
    the devices' lists, sums their window counts and runs PMI
    (:func:`pmi_edges_from_pairs`): the edges and weights equal the native
    kernel's bit for bit. Each device counts on a thread of its own, so the
    cards count at once: the JAX function dispatches the chunks
    round-robin from one thread, which in torch would serialize the cards
    at every ``torch.unique`` (its output size is read on the host).

    ``devices``: None means every visible card (:func:`sharded_devices`);
    a list may repeat a device (the tests count 8 shards on the CPU).
    Returns (coo [E,2] int32, weights [E] float32, n_windows).
    """
    tokens = _check_tokens(tokens, n_vocab)
    devs = sharded_devices() if devices is None else [torch.device(d) for d in devices]
    if not devs:
        raise ValueError("document-sharded counting needs at least one device")
    if tokens.shape[0] == 0:
        return np.zeros((0, 2), np.int32), np.zeros(0, np.float32), 0
    bounds = np.linspace(0, tokens.shape[0], len(devs) + 1).astype(np.int64)
    shards = [(tokens[lo:hi], dev) for dev, lo, hi in zip(devs, bounds[:-1], bounds[1:])
              if hi > lo]

    def count(shard):
        part, dev = shard
        keys, counts, n_windows = _count_on(part, n_vocab, window_size, chunk_pair_budget, dev)
        return keys.cpu(), counts.cpu(), n_windows

    with ThreadPoolExecutor(max_workers=len(shards)) as pool:
        parts = list(pool.map(count, shards))  # re-raises a shard's exception
    keys, counts, n_windows = parts[0]
    for more_keys, more_counts, more_windows in parts[1:]:
        keys, counts = _merge_keyed(keys, counts, more_keys, more_counts)
        n_windows += more_windows
    return _pmi_of_keys(keys, counts, n_vocab, n_windows)


def word_word_edges(
    tokens: np.ndarray,
    n_vocab: int,
    window_size: int = 20,
    backend: str = "auto",
    n_jobs: int = 0,
    device: Optional[Union[str, torch.device]] = None,
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Compute word-word PMI edges. ``backend``: 'native' (multithreaded C++
    host kernel), 'device' (sparse torch counting on ``device``, see
    :func:`word_word_edges_device`), 'sharded' (the documents sharded over
    every visible card, or over ``device`` where one is named, see
    :func:`word_word_edges_sharded`), 'oracle' (python-loop clone; tiny
    inputs only), or 'auto'.

    'auto' runs the native kernel while its packed V(V+1)/2 count triangle
    (4 bytes per cell) stays under ``PYTEXTGCN_NATIVE_TRI_BYTES`` (default
    2 GB, ~V=31.6k), and the device path above that; ``backend='native'``
    overrides the limit. ``device`` (None = the GPU) is resolved only when
    the device path runs, so 'auto' under the limit needs no GPU. Where the
    native library fails to build, 'auto' raises: it does not fall back to
    the device path as the JAX package does.

    ``n_jobs``: native-kernel thread count; 0 = hardware concurrency.
    Returns (coo [E,2] int32, weights [E] float32, n_windows).
    """
    if backend == "auto":
        tri_bytes = n_vocab * (n_vocab + 1) // 2 * 4
        limit = int(os.environ.get("PYTEXTGCN_NATIVE_TRI_BYTES", 2_000_000_000))
        backend = "device" if tri_bytes > limit else "native"
    if backend == "native":
        return native_word_word_edges(tokens, n_vocab, window_size, n_jobs)
    if backend == "device":
        return word_word_edges_device(tokens, n_vocab, window_size, device=device)
    if backend == "oracle":
        c_ij, n_windows = sliding_window_counts(tokens, n_vocab, window_size)
        # expand packed triangle into sparse pair lists
        idx = np.flatnonzero(c_ij)
        rows, cols = _tri_unpack(idx, n_vocab)
        coo, wgt = pmi_edges_from_pairs(
            rows.astype(np.int32), cols.astype(np.int32), c_ij[idx], n_vocab, n_windows
        )
        return coo, wgt, n_windows
    if backend == "sharded":
        return word_word_edges_sharded(tokens, n_vocab, window_size,
                                       devices=sharded_devices(device))
    raise ValueError(f"unknown backend {backend!r}")


def _tri_unpack(flat_idx: np.ndarray, n: int):
    """Invert ``tri_diag_index`` for a packed upper triangle incl. diagonal,
    returning (row, col) with row <= col, in ascending flat order."""
    # row r starts at offset r*n - r(r-1)/2; solve for r by searchsorted.
    r = np.arange(n, dtype=np.int64)
    row_starts = r * n - (r * (r - 1)) // 2
    rows = np.searchsorted(row_starts, flat_idx, side="right") - 1
    cols = flat_idx - row_starts[rows] + rows
    return rows, cols
