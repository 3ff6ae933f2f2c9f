"""Worker: the port's native C++ counting kernel under a sanitizer build.

Run as ``python torch_sanitized_worker.py <libtgnative_{asan,tsan}.so>``
with the matching sanitizer runtime LD_PRELOADed. Imports nothing beyond
numpy and ctypes (no torch, no package ``__init__``): the sanitizer should
watch the kernel, not a runtime it was not built for. It loads the port's
``build/native_bridge.py`` alone, from its file.

The checks of ``tests/sanitized_worker.py``, on the port's library:
1. small-vocabulary golden counts against the inline oracle of the
   reference's sliding-window semantics, with 1 and 4 threads;
2. the same counts, PMI and COO edges with 1 and 8 threads at a scale that
   runs the per-thread private arrays' merge: integer counting is exact, so
   any difference is a race.
"""

import ctypes
import importlib.util
import os
import sys

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, _HERE)

from sanitized_worker import oracle_counts  # noqa: E402


def _load_bridge():
    path = os.path.join(os.path.dirname(_HERE), "pytextgcn_tpu_torch", "build",
                        "native_bridge.py")
    spec = importlib.util.spec_from_file_location("torch_native_bridge", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    lib_path = sys.argv[1]
    nb = _load_bridge()
    nb._LIB = nb.declare_api(ctypes.CDLL(lib_path))
    rng = np.random.default_rng(0)

    # 1. golden against the inline oracle, single- and multi-threaded
    v, w, docs, max_len = 40, 5, 150, 30
    lens = rng.integers(1, max_len + 1, docs)
    toks = np.full((docs, max_len), -1, np.int32)
    for i, length in enumerate(lens):
        toks[i, :length] = rng.integers(0, v, length)
    cij_ref, nw_ref = oracle_counts(toks, v, w)
    for nt in (1, 4):
        cij, nw = nb.native_sliding_window_counts(toks, v, w, n_threads=nt)
        assert nw == nw_ref, (nt, nw, nw_ref)
        np.testing.assert_array_equal(cij.astype(np.uint64), cij_ref)

    # 2. thread-count determinism through the merge of per-thread arrays
    v2, w2, docs2, max_len2 = 3000, 20, 800, 64
    lens2 = rng.integers(1, max_len2 + 1, docs2)
    toks2 = np.full((docs2, max_len2), -1, np.int32)
    for i, length in enumerate(lens2):
        toks2[i, :length] = rng.integers(0, v2, length)
    coo1, w1, n1 = nb.native_word_word_edges(toks2, v2, w2, n_threads=1)
    coo8, w8, n8 = nb.native_word_word_edges(toks2, v2, w2, n_threads=8)
    assert n1 == n8, (n1, n8)
    np.testing.assert_array_equal(coo1, coo8)
    np.testing.assert_array_equal(w1, w8)
    assert len(w1) > 0

    print("SAN_OK", flush=True)


if __name__ == "__main__":
    main()
