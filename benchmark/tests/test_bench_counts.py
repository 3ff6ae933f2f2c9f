"""The operation and byte counts against hand counts on a tiny graph."""

import pytest

from benchmark import counts

GCN = {"kind": "gcn", "n_gcn": 2, "n_hidden": 3}
EGCN = dict(GCN, kind="egcn", embedding_dim=5)
F32 = {"dtype": "float32", "tf32": False}


def test_flops_gcn_by_hand():
    # N = 4 nodes, E = 6 edges, H = 3, C = 2: nnz = 10
    # train: A(W1) 2*10*3, A(h W2) 2*10*2 + 2*4*3*2, and each backward twice
    # that; eval: the two forwards again
    fwd = 2 * 10 * 3 + 2 * 10 * 2 + 2 * 4 * 3 * 2
    bwd = 2 * 10 * 3 + 2 * 10 * 2 + 2 * (2 * 4 * 3 * 2)
    assert counts.flops_per_epoch(GCN, 4, 6, 2) == fwd + bwd + fwd


def test_flops_egcn_adds_the_embedding_product_four_times():
    emb = 2 * 4 * 5 * 3  # [4, 5] x [5, 3]
    assert counts.flops_per_epoch(EGCN, 4, 6, 2) == counts.flops_per_epoch(GCN, 4, 6, 2) + 4 * emb


def test_flops_of_a_deeper_stack_by_hand():
    # 3 layers, H = 3, C = 2: A applications at 3, 3, 2; dense [4,3]x[3,3], [4,3]x[3,2]
    deep = dict(GCN, n_gcn=3)
    spmm = 3 * 2 * 10 * (3 + 3 + 2)
    dense = 4 * (2 * 4 * 3 * 3 + 2 * 4 * 3 * 2)
    assert counts.flops_per_epoch(deep, 4, 6, 2) == spmm + dense
    assert counts.spmm_widths(deep, 2) == [3, 3, 2, 2, 3, 3, 3, 3, 2]


def test_spmm_bytes_by_hand():
    # 6 edges x (4-byte index + 4-byte weight), 5 row offsets, x and out 4 x 3 floats
    assert counts.spmm_bytes(4, 6, 3) == 48 + 20 + 48 + 48
    assert counts.spmm_widths(GCN, 2) == [3, 2, 2, 3, 3, 2]


def test_least_time_is_the_larger_bound():
    n, e = 77_923, 13_310_312
    least = counts.spmm_least_s_per_epoch({"kind": "gcn", "n_gcn": 2, "n_hidden": 100},
                                          n, e, 43, F32)
    widths = (100, 43, 43, 100, 100, 43)
    by_app = [max(counts.spmm_bytes(n, e, w) / 3350e9, 2 * e * w / 67e12) for w in widths]
    assert least == pytest.approx(sum(by_app), rel=1e-12)
    # on the Amazon graph every application is bound by its bytes
    assert by_app == [counts.spmm_bytes(n, e, w) / 3350e9 for w in widths]


def test_peaks_and_launches():
    assert counts.peak_flops(F32) == 67e12
    assert counts.peak_flops({"dtype": "float32", "tf32": True}) == 495e12
    csr = {"hybrid_k": None, "masked_head": False, "use_pallas": True}
    assert counts.csr_launches_per_epoch(csr, GCN, 1) == 6
    with pytest.raises(NotImplementedError):
        counts.csr_launches_per_epoch(dict(csr, hybrid_k=4096), GCN, 1)
    with pytest.raises(NotImplementedError):
        counts.csr_launches_per_epoch(csr, GCN, 2)
