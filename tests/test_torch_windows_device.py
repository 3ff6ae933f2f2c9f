"""The port's sparse device counting (``build/windows.py::word_word_edges_device``,
here on the CPU) against the JAX package's 'device' and 'oracle' backends and
the port's native kernel: the same edges in the same order, the same float32
PMI weights bit for bit, the same window count."""

import numpy as np
import pytest
import torch

from pytextgcn_tpu.build.windows import word_word_edges as jax_word_word_edges
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.build import windows
from pytextgcn_tpu_torch.data import synthetic_corpus

# the reference's hand-computed fixture (tests/test_windows.py): 2 docs, 6
# words, window 3, one padded
GOLDEN_X = np.array([[0, 1, 2, 3, 4, -1, -1, -1], [5, 3, 4, 1, 2, 0, 5, 1]], dtype=np.int32)


def _assert_same(got, want):
    assert got[2] == want[2], "n_windows"
    assert got[0].dtype == want[0].dtype == np.int32
    assert got[1].dtype == want[1].dtype == np.float32
    np.testing.assert_array_equal(got[0], want[0])  # the emission order too
    assert got[1].tobytes() == want[1].tobytes()  # bit for bit


def _random_corpus(rng, n_docs, seq_len, n_vocab):
    """Padded token rows whose lengths are drawn from 0 (empty documents
    and documents shorter than the window included)."""
    lengths = rng.integers(0, seq_len + 1, size=n_docs)
    x = np.full((n_docs, seq_len), -1, dtype=np.int32)
    for i, length in enumerate(lengths):
        x[i, :length] = rng.integers(0, n_vocab, size=length)
    return x


def _fuzz_trials():
    """tests/test_windows.py's four fuzz trials, with its seed."""
    rng = np.random.default_rng(0)
    trials = []
    for _ in range(4):
        n_docs = int(rng.integers(1, 12))
        seq_len = int(rng.integers(2, 30))
        n_vocab = int(rng.integers(2, 15))
        window = int(rng.integers(2, 8))
        trials.append((_random_corpus(rng, n_docs, seq_len, n_vocab), n_vocab, window))
    return trials


@pytest.mark.parametrize("jax_backend", ["device", "oracle"])
def test_golden_corpus_matches_jax(jax_backend):
    got = windows.word_word_edges(GOLDEN_X, 6, 3, backend="device", device="cpu")
    assert got[2] == 9
    _assert_same(got, jax_word_word_edges(GOLDEN_X, 6, 3, backend=jax_backend))


@pytest.mark.parametrize("budget", [1 << 24, 1], ids=["default-budget", "one-doc-chunks"])
@pytest.mark.parametrize("jax_backend", ["device", "oracle"])
def test_fuzz_matches_jax(jax_backend, budget):
    for tokens, n_vocab, window in _fuzz_trials():
        got = windows.word_word_edges_device(tokens, n_vocab, window,
                                             chunk_pair_budget=budget, device="cpu")
        _assert_same(got, jax_word_word_edges(tokens, n_vocab, window, backend=jax_backend))


@pytest.fixture(scope="module")
def corpus_3000():
    """tests/test_windows.py's 3,000-document corpus of rows up to 48 tokens
    and its native count."""
    tokens = _random_corpus(np.random.default_rng(3), 3000, 48, 500)
    return tokens, windows.word_word_edges(tokens, 500, 10, backend="native")


@pytest.mark.parametrize("budget", [1 << 24, 1 << 14], ids=["default-budget", "many-chunks"])
def test_3000_docs_match_native(corpus_3000, budget):
    tokens, native = corpus_3000
    n_chunks = sum(1 for _ in windows._iter_chunks(tokens, 10, budget))
    assert (n_chunks == 3) if budget == 1 << 24 else (n_chunks > 50)
    _assert_same(windows.word_word_edges_device(tokens, 500, 10, chunk_pair_budget=budget,
                                                device="cpu"), native)


def test_merge_sums_counts_in_int64():
    keys = torch.tensor([1, 4, 9])
    counts = torch.tensor([2**31 - 1, 5, 1])
    merged, summed = windows._merge_keyed(keys, counts, torch.tensor([0, 1, 9]),
                                          torch.tensor([3, 2**31 - 1, 1]))
    assert merged.tolist() == [0, 1, 4, 9]
    assert summed.dtype == torch.int64
    assert summed.tolist() == [3, 2**32 - 2, 5, 2]


def test_auto_routes_above_the_limit_to_the_device(monkeypatch, corpus_3000):
    """Above ``PYTEXTGCN_NATIVE_TRI_BYTES`` 'auto' counts on the device (no
    native call); under it, it counts natively and resolves no device."""
    tokens, native = corpus_3000
    tri_bytes = 500 * 501 // 2 * 4
    monkeypatch.setenv("PYTEXTGCN_NATIVE_TRI_BYTES", str(tri_bytes - 1))

    def no_native(*args, **kwargs):
        raise AssertionError("'auto' above the limit called the native kernel")

    with monkeypatch.context() as m:
        m.setattr(windows, "native_word_word_edges", no_native)
        _assert_same(windows.word_word_edges(tokens, 500, 10, backend="auto", device="cpu"),
                     native)
    monkeypatch.setenv("PYTEXTGCN_NATIVE_TRI_BYTES", str(tri_bytes))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _assert_same(windows.word_word_edges(tokens, 500, 10, backend="auto"), native)


def test_native_failure_is_not_hidden(monkeypatch):
    """Where the native library fails, 'auto' raises: it does not fall back
    to the device path as the JAX package does."""

    def broken(*args, **kwargs):
        raise OSError("the native library failed to build")

    monkeypatch.setattr(windows, "native_word_word_edges", broken)
    with pytest.raises(OSError, match="failed to build"):
        windows.word_word_edges(GOLDEN_X, 6, 3, backend="auto", device="cpu")


def test_refusals():
    # 'sharded' no longer raises: the device backend's edges over the CPU
    _assert_same(windows.word_word_edges(GOLDEN_X, 6, 3, backend="sharded", device="cpu"),
                 windows.word_word_edges_device(GOLDEN_X, 6, 3, device="cpu"))
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        windows.word_word_edges_device(GOLDEN_X, 5, 3, device="cpu")
    empty = windows.word_word_edges_device(np.zeros((0, 4), np.int32), 6, 3, device="cpu")
    assert empty[0].shape == (0, 2) and empty[1].shape == (0,) and empty[2] == 0


def test_text2graph_device_backend_equals_native():
    docs, labels = synthetic_corpus(n_docs=240, n_classes=4, seed=5)
    kw = dict(min_df=1, window_size=5)
    got = Text2Graph(backend="device", device="cpu", **kw).fit_transform(docs, labels)
    want = Text2Graph(backend="native", **kw).fit_transform(docs, labels)
    for f in ("edge_src", "edge_dst", "edge_w"):
        assert np.asarray(getattr(got, f)).tobytes() == np.asarray(getattr(want, f)).tobytes()
