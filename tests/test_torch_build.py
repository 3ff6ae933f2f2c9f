"""Port graph building (pytextgcn_tpu_torch.build/data/core) against the JAX
package: same corpus in, bitwise-equal graph out."""

import hashlib

import numpy as np
import pytest
import torch

from pytextgcn_tpu import Text2Graph as JaxText2Graph
from pytextgcn_tpu import TextGraph as JaxTextGraph
from pytextgcn_tpu.core.graph import gcn_normalize_np as jax_gcn_normalize_np
from pytextgcn_tpu.data.synthetic import protocol_corpus as jax_protocol_corpus
from pytextgcn_tpu.data.synthetic import synthetic_corpus as jax_synthetic_corpus
from pytextgcn_tpu_torch import Text2Graph, TextGraph
from pytextgcn_tpu_torch.build import windows
from pytextgcn_tpu_torch.core.graph import gcn_normalize_np
from pytextgcn_tpu_torch.data.synthetic import protocol_corpus, synthetic_corpus

FIELDS = ("edge_src", "edge_dst", "edge_w", "y", "train_mask", "val_mask", "test_mask")


def _split(n, seed=0):
    rng = np.random.default_rng(seed)
    test_idx = rng.choice(n, n // 5, replace=False)
    val_idx = np.setdiff1d(rng.choice(n, n // 5, replace=False), test_idx)
    return test_idx, val_idx


@pytest.mark.parametrize(
    "kwargs",
    [
        dict(min_df=1, window_size=5),
        dict(min_df=2, max_df=0.9, window_size=4, max_length=12),
        dict(min_df=1, window_size=3, backend="oracle"),
    ],
    ids=["native", "df-pruned-truncated", "oracle"],
)
def test_text2graph_bitwise_equal_to_jax(kwargs):
    docs, labels = synthetic_corpus(n_docs=240, n_classes=4, seed=5)
    test_idx, val_idx = _split(len(docs))
    got = Text2Graph(**kwargs).fit_transform(docs, labels, test_idx=test_idx, val_idx=val_idx)
    want = JaxText2Graph(**kwargs).fit_transform(docs, labels, test_idx=test_idx,
                                                 val_idx=val_idx)
    assert (got.n_vocab, got.n_docs) == (want.n_vocab, want.n_docs)
    assert got.weight_symmetric == want.weight_symmetric
    for f in FIELDS:
        a, b = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype, f
        assert a.tobytes() == b.tobytes(), f


def test_corpus_generators_match_jax():
    assert synthetic_corpus(n_docs=50, n_classes=3, n_parents=2, seed=9) == \
        jax_synthetic_corpus(n_docs=50, n_classes=3, n_parents=2, seed=9)
    for protocol in ("amazon", "amazon-f1", "dbpedia"):
        docs, levels, n_train, n_val = protocol_corpus(protocol, n_docs=120, seed=3)
        jdocs, jlevels, jn_train, jn_val = jax_protocol_corpus(protocol, n_docs=120, seed=3)
        digest = lambda ds: hashlib.blake2b("\n".join(ds).encode()).hexdigest()
        assert digest(docs) == digest(jdocs)
        assert (n_train, n_val) == (jn_train, jn_val)
        for a, b in zip(levels, jlevels):
            np.testing.assert_array_equal(a, b)


def test_npz_round_trip_across_packages(tmp_path):
    docs, labels = synthetic_corpus(n_docs=60, n_classes=3, seed=1)
    g = Text2Graph(min_df=1, window_size=4).fit_transform(docs, labels, test_idx=[0, 1])
    g.save(str(tmp_path / "port"))
    back = JaxTextGraph.load(str(tmp_path / "port"))
    jg = JaxText2Graph(min_df=1, window_size=4).fit_transform(docs, labels, test_idx=[0, 1])
    jg.save(str(tmp_path / "jax.npz"))
    fwd = TextGraph.load(str(tmp_path / "jax.npz"))
    for f in FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, f)), getattr(g, f))
        np.testing.assert_array_equal(getattr(fwd, f), np.asarray(getattr(jg, f)))
    assert (fwd.n_vocab, fwd.n_docs, fwd.weight_symmetric) == (jg.n_vocab, jg.n_docs, True)


def test_gcn_normalize_matches_jax():
    rng = np.random.default_rng(4)
    src, dst = rng.integers(0, 50, 300), rng.integers(0, 50, 300)
    w = rng.random(300).astype(np.float32)
    for a, b in zip(gcn_normalize_np(src, dst, w, 50), jax_gcn_normalize_np(src, dst, w, 50)):
        assert a.tobytes() == b.tobytes()


def test_unported_counting_backends_raise(monkeypatch):
    tokens = np.array([[0, 1, 2, -1]], np.int32)
    ocoo, ow, on = windows.word_word_edges(tokens, 3, 2, backend="oracle")
    # 'sharded' is ported (tests/test_torch_windows_sharded.py): the oracle's
    # edges over the devices named
    scoo, sw, sn = windows.word_word_edges(tokens, 3, 2, backend="sharded", device="cpu")
    assert sn == on and np.array_equal(scoo, ocoo) and sw.tobytes() == ow.tobytes()
    # 'auto' above the native triangle limit counts on the device: the GPU
    # unless a device is given, never the CPU in its place
    monkeypatch.setenv("PYTEXTGCN_NATIVE_TRI_BYTES", "8")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backend in ("auto", "sharded"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            windows.word_word_edges(tokens, 3, 2, backend=backend)
    for backend, kw in (("auto", {"device": "cpu"}), ("device", {"device": "cpu"}),
                        ("native", {})):
        coo, w, n_windows = windows.word_word_edges(tokens, 3, 2, backend=backend, **kw)
        np.testing.assert_array_equal(coo, ocoo)
        np.testing.assert_array_equal(w, ow)
        assert n_windows == on
