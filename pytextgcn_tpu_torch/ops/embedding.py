"""EGCN's embedding activation, ``dropout(selu(W + b))``, as one pass each way.

With identity features EGCN's embedding is ``W_emb + b`` over ``[N, E]``
(``models/gcn.py::EGCN``). Eagerly torch runs its bias, SELU and dropout as
separate passes: the add, SELU, the compare, the multiply by ``1 / keep`` and
``torch.where`` forward, three more backward, the add and SELU again in the
evaluation. On the card :class:`SeluDropout` runs each direction as one launch
of ``csrc/embedding.cu`` (whose header sets out the design), equal to that
composition bit for bit; the dropout's uniforms still come from torch's
generator, drawn as :func:`models.layers.dropout` draws them.

* :func:`takes` — whether EGCN's embedding runs here.
* :func:`selu_dropout` — draws the uniforms and applies :class:`SeluDropout`.

Everywhere else, the CPU included, EGCN keeps the eager composition, which
is also what the card tests hold the kernels to.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from .cuda_lib import CudaLibrary
from .features import NodeFeatures

_p, _n, _i, _f = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_float
_LIB = CudaLibrary("embedding.cu", "embedding_forward", [_p, _p, _p, _p, _p, _n, _i, _f, _f, _p],
                   extra_symbols={"embedding_backward": [_p, _p, _p, _p, _p, _n, _i, _f, _p]})


def takes(w: torch.Tensor, feats: NodeFeatures, tp, rows) -> bool:
    """Whether EGCN's embedding ``selu(feats.matmul(w) + b)`` and its
    dropout run as :func:`selu_dropout`: on the card, with identity features
    whose product is ``w`` itself, no tensor-parallel layout (``tp``) and
    whole activations (``rows``, ``ops/spmm.py::row_block``). A
    tensor-parallel or halo rank draws a full-size mask and slices it, so it
    keeps the eager composition."""
    return (w.is_cuda and tp is None and rows is None and feats.is_identity
            and w.shape[0] == feats.n_nodes)


def _words(n: int) -> int:
    """Mask words for n elements: 4 for each 32 vectors of 4, one for the tail
    (``csrc/embedding.cu``: word 4g + k, bit l is element k of vector 32g + l;
    the last word holds the last ``n % 4`` elements from bit 0)."""
    return 4 * -(-(n // 4) // 32) + 1


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` if it is contiguous and 16-byte aligned, as the kernels read
    it, else a copy that is."""
    if t.is_contiguous() and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _launch(symbol: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _LIB.launch(symbol, *args, stream, symbol=symbol)
    SeluDropout.launches += 1


class SeluDropout(torch.autograd.Function):
    """``h = dropout(selu(w + b))`` for ``w`` ``[N, E]`` and ``b`` ``[E]``,
    the dropout at ``rate`` keeping ``u < 1 - rate`` when uniforms ``u`` are
    given, none without. On the card each direction is one launch of
    ``csrc/embedding.cu``: the forward writes ``h`` and a keep mask of one
    bit an element; the backward recomputes ``w + b`` and writes ``dw``
    whole, and ``db`` is torch's column sum of it, as autograd's reduction
    of the broadcast bias. It runs on CUDA tensors alone. ``launches``
    counts the kernels' launches that ran in the process; a CUDA graph's
    replays add the launches its capture recorded (``train/graphs.py``)."""

    launches = 0

    @staticmethod
    def forward(ctx, w: torch.Tensor, b: torch.Tensor, u: Optional[torch.Tensor],
                rate: float) -> torch.Tensor:
        ctx.rate = rate
        if not w.is_cuda:
            raise ValueError(f"the fused pass runs on a CUDA device, got {w.device}")
        if w.dim() != 2 or b.shape != w.shape[1:] or (u is not None and u.shape != w.shape):
            raise ValueError(f"w [N, E], b [E] and u of w's shape, got {list(w.shape)}, "
                             f"{list(b.shape)}, {None if u is None else list(u.shape)}")
        for t in (w, b) if u is None else (w, b, u):
            if t.dtype != torch.float32 or t.device != w.device:
                raise TypeError(f"float32 tensors on {w.device}, got {t.dtype} on {t.device}")
        w, b = _aligned(w), _aligned(b)
        h = torch.empty_like(w)
        mask = None
        if u is not None:
            u = _aligned(u)
            mask = torch.empty(_words(w.numel()), dtype=torch.int32, device=w.device)
        keep = np.float32(1.0 - rate)
        _launch("embedding_forward", w.device, w.data_ptr(), b.data_ptr(),
                None if u is None else u.data_ptr(), h.data_ptr(),
                None if mask is None else mask.data_ptr(), w.numel(), w.shape[1],
                float(keep), float(np.float32(1.0) / keep))
        ctx.save_for_backward(w, b, mask)
        return h

    @staticmethod
    def backward(ctx, dh: torch.Tensor):
        w, b, mask = ctx.saved_tensors
        dh = _aligned(dh)
        dw = torch.empty_like(w)
        keep = np.float32(1.0 - ctx.rate)
        _launch("embedding_backward", w.device, dh.data_ptr(), w.data_ptr(), b.data_ptr(),
                None if mask is None else mask.data_ptr(), dw.data_ptr(), w.numel(),
                w.shape[1], float(np.float32(1.0) / keep))
        db = dw.sum_to_size(b.shape) if ctx.needs_input_grad[1] else None
        return dw, db, None, None


def selu_dropout(w: torch.Tensor, b: torch.Tensor, rate: float, train: bool,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """``dropout(torch.selu(w + b), rate, train, generator)``
    (``models/layers.py::dropout``) through :class:`SeluDropout`: when
    training at a nonzero rate the uniforms are drawn from ``generator`` as
    that dropout draws them (one ``torch.rand`` of ``w``'s shape), so the
    masks and the generator's state are the same."""
    if not train or rate == 0.0:
        return SeluDropout.apply(w, b, None, 0.0)
    u = torch.rand(w.shape, generator=generator, device=w.device)
    return SeluDropout.apply(w, b, u, rate)
