"""ctypes bridge to the native C++ graph-builder kernels.

Compiles ``native/graphbuilder.cpp`` and ``native/vectorizer.cpp`` (copies
of the JAX package's kernels) with ``g++`` at first use into the package's
build directory (``_build/native``, listed in .gitignore), and exposes them
through a plain C ABI + ctypes. ``build_sanitized`` makes ASan/UBSan and
TSan builds of the same sources beside it.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRCS = [
    os.path.join(_HERE, "native", "graphbuilder.cpp"),
    os.path.join(_HERE, "native", "vectorizer.cpp"),
]
# the package's build directory (utils.BUILD_DIR), spelled out so that this
# module imports nothing of the package: the sanitizer worker loads it
# alone, without torch
_OUT_DIR = os.path.join(os.path.dirname(_HERE), "_build", "native")
_SO = os.path.join(_OUT_DIR, "libtgnative.so")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


# sanitizer builds: the threaded counting kernel is the kind of shared-state
# code ASan/UBSan and TSan exist for; tests/test_torch_sanitizers.py runs
# its golden and thread-count checks against these builds in subprocesses
# with the runtime preloaded
_SAN_FLAGS = {
    None: ["-O3", "-march=native"],
    "asan": ["-O1", "-g", "-fsanitize=address,undefined", "-fno-sanitize-recover=all"],
    "tsan": ["-O1", "-g", "-fsanitize=thread"],
}


def _san_so(sanitize: Optional[str]) -> str:
    suffix = "" if sanitize is None else f"_{sanitize}"
    return os.path.join(_OUT_DIR, f"libtgnative{suffix}.so")


def _build(sanitize: Optional[str] = None) -> str:
    """Compile into a temporary file and rename it into place, so processes
    building at the same time never load a half-written library."""
    out = _san_so(sanitize)
    os.makedirs(_OUT_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_OUT_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *_SAN_FLAGS[sanitize], "-std=c++17", "-fPIC", "-shared",
               "-pthread", *_SRCS, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def _stale(out: str) -> bool:
    return not os.path.exists(out) or any(
        os.path.getmtime(out) < os.path.getmtime(s) for s in _SRCS)


def build_sanitized(sanitize: str) -> str:
    """Build (if stale) and return the path of a sanitizer-instrumented
    variant of the native library ('asan' = address + undefined behaviour,
    'tsan' = thread)."""
    out = _san_so(sanitize)
    with _LOCK:
        if _stale(out):
            _build(sanitize)
    return out


def sanitizer_runtime(sanitize: str) -> str:
    """Path of the sanitizer runtime to LD_PRELOAD into the host process."""
    name = {"asan": "libasan.so", "tsan": "libtsan.so"}[sanitize]
    out = subprocess.run(["g++", f"-print-file-name={name}"], check=True,
                         capture_output=True, text=True)
    return out.stdout.strip()


def declare_api(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Attach the C ABI signatures to a loaded library handle."""
    lib.tg_sliding_window.restype = ctypes.c_uint64
    lib.tg_sliding_window.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.c_uint32),
    ]
    lib.tg_word_word_edges.restype = ctypes.c_int32
    lib.tg_word_word_edges.argtypes = [
        ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.c_int32,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.tg_free.restype = None
    lib.tg_free.argtypes = [ctypes.c_void_p]

    lib.tg_fit_counts.restype = ctypes.c_int64
    lib.tg_fit_counts.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
        ctypes.POINTER(ctypes.c_int64),
    ]
    lib.tg_encode.restype = ctypes.c_int64
    lib.tg_encode.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64,
        ctypes.c_char_p,
        ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int32)),
    ]
    return lib


def load_native() -> ctypes.CDLL:
    """Load (building if needed) the native library."""
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        # imported here: a process that loads this module alone from its file
        # (tests/torch_sanitized_worker.py) sets _LIB itself and never gets here
        from ..train.profiling import stage

        if _stale(_SO):
            with stage("kernels.build"):
                _build()
        with stage("kernels.load"):
            _LIB = declare_api(ctypes.CDLL(_SO))
        return _LIB


def _pack_docs(docs):
    """Concatenate documents into one UTF-8 buffer + int64 offsets."""
    encoded = [d.encode("utf-8") for d in docs]
    offsets = np.zeros(len(encoded) + 1, dtype=np.int64)
    np.cumsum([len(b) for b in encoded], out=offsets[1:])
    return b"".join(encoded), offsets


def native_fit_counts(docs, stop_words, min_doc_count: int, max_doc_count: int):
    """C++ vocabulary fit + CSR counts for ASCII corpora.
    Returns (vocabulary dict, scipy CSR int64)."""
    from scipy import sparse as sp

    lib = load_native()
    text, offsets = _pack_docs(docs)
    stop = "\n".join(sorted(stop_words)) if stop_words else ""
    vocab_p = ctypes.c_char_p()
    vocab_len = ctypes.c_int64()
    indptr_p = ctypes.POINTER(ctypes.c_int64)()
    indices_p = ctypes.POINTER(ctypes.c_int32)()
    data_p = ctypes.POINTER(ctypes.c_int64)()
    nnz = ctypes.c_int64()
    n_terms = lib.tg_fit_counts(
        text,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs),
        stop.encode(),
        min_doc_count,
        max_doc_count,
        ctypes.byref(vocab_p),
        ctypes.byref(vocab_len),
        ctypes.byref(indptr_p),
        ctypes.byref(indices_p),
        ctypes.byref(data_p),
        ctypes.byref(nnz),
    )
    if n_terms == -2:
        raise ValueError("empty vocabulary after df pruning")
    if n_terms < 0:
        raise MemoryError("native vectorizer failed")
    try:
        vocab_str = ctypes.string_at(vocab_p, vocab_len.value).decode("utf-8")
        indptr = np.ctypeslib.as_array(indptr_p, shape=(len(docs) + 1,)).copy()
        e = nnz.value
        indices = (
            np.ctypeslib.as_array(indices_p, shape=(e,)).copy() if e else np.zeros(0, np.int32)
        )
        data = np.ctypeslib.as_array(data_p, shape=(e,)).copy() if e else np.zeros(0, np.int64)
    finally:
        lib.tg_free(vocab_p)
        lib.tg_free(indptr_p)
        lib.tg_free(indices_p)
        lib.tg_free(data_p)
    terms = vocab_str.split("\n")[:-1]
    assert len(terms) == n_terms
    vocabulary = {t: i for i, t in enumerate(terms)}
    counts = sp.csr_matrix((data, indices, indptr), shape=(len(docs), n_terms))
    return vocabulary, counts


def native_encode(docs, vocabulary_sorted_terms, max_length=None):
    """C++ token-id encoding (reference _encode_input semantics).

    ``max_length=None`` disables truncation; ``0`` truncates every document
    to zero tokens (degenerate but well-defined — the Python path slices
    ``ids[:0]``, and the two paths must agree; the C ABI uses 0 for
    'disabled', so the 0 case short-circuits here)."""
    if max_length == 0:
        return np.zeros((len(docs), 0), np.int32)
    lib = load_native()
    text, offsets = _pack_docs(docs)
    vocab = ("\n".join(vocabulary_sorted_terms) + "\n").encode("utf-8")
    tokens_p = ctypes.POINTER(ctypes.c_int32)()
    max_len = lib.tg_encode(
        text,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(docs),
        vocab,
        max_length or 0,
        ctypes.byref(tokens_p),
    )
    if max_len < 0:
        raise MemoryError("native encoder failed")
    try:
        if max_len == 0:
            return np.zeros((len(docs), 0), np.int32)
        out = np.ctypeslib.as_array(tokens_p, shape=(len(docs), max_len)).copy()
    finally:
        lib.tg_free(tokens_p)
    return out


def native_sliding_window_counts(
    tokens: np.ndarray, n_vocab: int, window_size: int, n_threads: int = 0
) -> Tuple[np.ndarray, int]:
    """Packed triangular pair counts and the window count from the C++
    kernel (the reference's test hook ``sliding_window_tester``)."""
    lib = load_native()
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    n_docs, seq_len = tokens.shape
    cij = np.zeros((n_vocab * (n_vocab + 1)) // 2, dtype=np.uint32)
    n_windows = lib.tg_sliding_window(
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_docs,
        seq_len,
        n_vocab,
        window_size,
        n_threads,
        cij.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return cij, int(n_windows)


def native_word_word_edges(
    tokens: np.ndarray, n_vocab: int, window_size: int = 20, n_threads: int = 0
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Full counting + PMI + COO extraction in C++.
    Returns (coo [E,2] int32, weights [E] float32, n_windows); arrays are
    copies owned by numpy (the reference leaks its malloc'd buffers by
    wrapping them without an owner, graphbuilder.pyx:65-66 — we don't)."""
    lib = load_native()
    tokens = np.ascontiguousarray(tokens, dtype=np.int32)
    n_docs, seq_len = tokens.shape
    coo_p = ctypes.POINTER(ctypes.c_int32)()
    w_p = ctypes.POINTER(ctypes.c_float)()
    n_edges = ctypes.c_int64()
    n_windows = ctypes.c_uint64()
    rc = lib.tg_word_word_edges(
        tokens.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_docs,
        seq_len,
        n_vocab,
        window_size,
        n_threads,
        ctypes.byref(coo_p),
        ctypes.byref(w_p),
        ctypes.byref(n_edges),
        ctypes.byref(n_windows),
    )
    if rc != 0:
        raise MemoryError("native graph builder failed to allocate")
    e = n_edges.value
    try:
        coo = np.ctypeslib.as_array(coo_p, shape=(e, 2)).copy() if e else np.zeros((0, 2), np.int32)
        wgt = np.ctypeslib.as_array(w_p, shape=(e,)).copy() if e else np.zeros(0, np.float32)
    finally:
        lib.tg_free(coo_p)
        lib.tg_free(w_p)
    return coo, wgt, int(n_windows.value)
