"""The port's document-sharded counting (``build/windows.py::
word_word_edges_sharded``, here over CPU "devices") against the port's
native kernel and the JAX package's ``word_word_edges_sharded`` on its 8
virtual CPU devices: the same edges in the same order, the same float32 PMI
weights bit for bit, the same window count."""

import numpy as np
import pytest
import torch

from pytextgcn_tpu.build.windows import word_word_edges as jax_word_word_edges
from pytextgcn_tpu.build.windows import word_word_edges_sharded as jax_sharded
from pytextgcn_tpu.parallel import make_mesh
from pytextgcn_tpu_torch import Text2Graph
from pytextgcn_tpu_torch.build import windows
from pytextgcn_tpu_torch.data import synthetic_corpus

from test_torch_windows_device import GOLDEN_X, _assert_same, _fuzz_trials, _random_corpus

CPU8 = ["cpu"] * 8


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Several test workers share the machine; each shard counts on a
    thread of its own besides."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus_3000():
    """tests/test_windows.py:104-124's corpus: 3,000 documents of up to 48
    tokens over 500 words, window 10; the native kernel's count."""
    tokens = _random_corpus(np.random.default_rng(3), 3000, 48, 500)
    return tokens, windows.word_word_edges(tokens, 500, 10, backend="native")


@pytest.mark.parametrize("budget", [1 << 24, 1 << 14], ids=["default-budget", "many-chunks"])
def test_3000_docs_over_8_devices_match_native_and_jax(corpus_3000, budget):
    tokens, native = corpus_3000
    got = windows.word_word_edges_sharded(tokens, 500, 10, devices=CPU8,
                                          chunk_pair_budget=budget)
    _assert_same(got, native)
    _assert_same(got, jax_sharded(tokens, 500, 10, mesh=make_mesh(8)))


@pytest.mark.parametrize("n_devices", [1, 3, 8])
def test_fuzz_matches_jax_oracle(n_devices):
    """tests/test_windows.py:127-143's fuzz with the sharded backend: more
    shards than documents leaves shards empty, which count nothing."""
    for tokens, n_vocab, window in _fuzz_trials():
        got = windows.word_word_edges_sharded(tokens, n_vocab, window,
                                              devices=["cpu"] * n_devices)
        _assert_same(got, jax_word_word_edges(tokens, n_vocab, window, backend="oracle"))


def test_golden_corpus_through_the_dispatcher():
    got = windows.word_word_edges(GOLDEN_X, 6, 3, backend="sharded", device="cpu")
    assert got[2] == 9
    _assert_same(got, jax_word_word_edges(GOLDEN_X, 6, 3, backend="sharded"))


def test_sharded_devices(monkeypatch):
    """None and 'cuda' spread over every visible card, a named device is
    used alone; without a card None raises instead of taking the CPU."""
    assert windows.sharded_devices("cpu") == [torch.device("cpu")]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    want = [torch.device("cuda", i) for i in range(3)]
    assert windows.sharded_devices() == windows.sharded_devices("cuda") == want
    assert windows.sharded_devices("cuda:2") == [torch.device("cuda", 2)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        windows.sharded_devices()
    with pytest.raises(ValueError, match="at least one device"):
        windows.word_word_edges_sharded(GOLDEN_X, 6, 3, devices=[])
    with pytest.raises(ValueError, match=r"\[0, 5\)"):
        windows.word_word_edges_sharded(GOLDEN_X, 5, 3, devices=CPU8)
    empty = windows.word_word_edges_sharded(np.zeros((0, 4), np.int32), 6, 3, devices=CPU8)
    assert empty[0].shape == (0, 2) and empty[1].shape == (0,) and empty[2] == 0


def test_a_shard_s_failure_is_raised(monkeypatch):
    """A device whose count fails fails the whole count."""
    calls = []
    real = windows._count_on

    def flaky(tokens, n_vocab, window_size, budget, device):
        calls.append(device)
        if len(calls) == 2:
            raise RuntimeError("device lost")
        return real(tokens, n_vocab, window_size, budget, device)

    monkeypatch.setattr(windows, "_count_on", flaky)
    with pytest.raises(RuntimeError, match="device lost"):
        windows.word_word_edges_sharded(GOLDEN_X, 6, 3, devices=["cpu", "cpu"])


def test_text2graph_sharded_backend_equals_native():
    docs, labels = synthetic_corpus(n_docs=240, n_classes=4, seed=5)
    kw = dict(min_df=1, window_size=5)
    got = Text2Graph(backend="sharded", device="cpu", **kw).fit_transform(docs, labels)
    want = Text2Graph(backend="native", **kw).fit_transform(docs, labels)
    for f in ("edge_src", "edge_dst", "edge_w"):
        assert np.asarray(getattr(got, f)).tobytes() == np.asarray(getattr(want, f)).tobytes()
