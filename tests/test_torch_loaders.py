"""The port's CSV loaders (``data/loaders.py``), the CSV branches of its
``load_corpus`` (``experiments/common.py``) and its baked sklearn stopword
list, against the JAX package (pandas) on CSVs the tests write: documents,
raw labels, encodings and split indices equal."""

import csv
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "experiments"))

from pytextgcn_tpu.config import parse_config as jax_parse_config
from pytextgcn_tpu.data import loaders as jax_loaders
from pytextgcn_tpu_torch.build.stopwords import get_stopwords
from pytextgcn_tpu_torch.config import check_ported, parse_config
from pytextgcn_tpu_torch.data import loaders
from pytextgcn_tpu_torch.experiments import common, flat
from pytextgcn_tpu_torch.experiments import mlp as mlp_driver

# quoted commas, quotes and newlines inside fields
TRICKY = ['great, really "great" value', "two\nlines, one review", "plain words here"]


def _write(path, header, rows):
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    words = ["alpha", "beta", "gamma", "delta", "omega", "kappa", "sigma", "theta"]
    return [TRICKY[i] if i < len(TRICKY) else " ".join(rng.choice(words, 6))
            for i in range(n)]


def _amazon(tmp_path):
    d = tmp_path / "amazon"
    d.mkdir()
    for name, n, seed in (("train.csv", 12, 0), ("test.csv", 6, 1)):
        rng = np.random.default_rng(seed)
        _write(d / name, ["Text", "Cat1", "Cat2"],
               [[t, f"top{rng.integers(2)}", int(rng.choice([2, 10, 7]))]
                for t in _docs(n, seed)])
    return d


def _dbpedia(tmp_path):
    d = tmp_path / "dbpedia"
    d.mkdir()
    for name, n, seed in (("DBPEDIA_train.csv", 10, 2), ("DBPEDIA_val.csv", 4, 3),
                          ("DBPEDIA_test.csv", 5, 4)):
        rng = np.random.default_rng(seed)
        _write(d / name, ["text", "l1", "l2", "l3"],
               [[t, f"A{rng.integers(2)}", f"B{rng.integers(3)}", f"C{rng.integers(4)}"]
                for t in _docs(n, seed)])
    return d


def _csv(tmp_path, with_val, text_col="body"):
    d = tmp_path / ("csv_val" if with_val else "csv")
    d.mkdir()
    files = [("train.csv", 14, 5), ("test.csv", 6, 6)] + ([("val.csv", 4, 7)] if with_val
                                                          else [])
    for name, n, seed in files:
        rng = np.random.default_rng(seed)
        _write(d / name, ["id", text_col, "coarse", "fine"],
               [[i, t, f"p{rng.integers(2)}", int(rng.choice([2, 10]))]
                for i, t in enumerate(_docs(n, seed))])
    return d


def test_sklearn_stopwords_are_sklearns():
    from sklearn.feature_extraction.text import ENGLISH_STOP_WORDS

    assert get_stopwords("sklearn") == frozenset(ENGLISH_STOP_WORDS)
    assert len(get_stopwords("sklearn")) == 318


def test_load_amazon_and_dbpedia_match_jax(tmp_path):
    a = _amazon(tmp_path)
    for label in ("Cat1", "Cat2"):
        assert loaders.load_amazon(str(a), label) == tuple(jax_loaders.load_amazon(str(a), label))
    ours = loaders.load_amazon(str(a), "Cat2")
    assert ours[0][:2] == TRICKY[:2] and {type(v) for v in ours[1]} == {int}
    d = _dbpedia(tmp_path)
    for label in ("l1", "l2", "l3"):
        assert loaders.load_dbpedia(str(d), label) == tuple(
            jax_loaders.load_dbpedia(str(d), label))


def test_integer_labels_encode_as_jax_does(tmp_path):
    """pandas reads 2 and 10 as integers, so they sort 2 < 10: labels 2, 10
    encode as 0, 1 (read as strings they would encode as 1, 0)."""
    a = _amazon(tmp_path)
    y_tr, y_te = loaders.load_amazon(str(a), "Cat2")[1::2]
    ours = loaders.encode_labels(y_tr, y_te)
    theirs = jax_loaders.encode_labels(*jax_loaders.load_amazon(str(a), "Cat2")[1::2])
    for o, t in zip(ours, theirs):
        np.testing.assert_array_equal(o, t)
    assert loaders.encode_labels([2, 10, 7]) [0].tolist() == [0, 2, 1]


@pytest.mark.parametrize("with_val", [False, True])
@pytest.mark.parametrize("text_col", [None, "body"])
def test_load_csv_dataset_matches_jax(tmp_path, with_val, text_col):
    d = _csv(tmp_path, with_val)
    ours = loaders.load_csv_dataset(str(d), ["coarse", "fine"], text_col=text_col)
    theirs = jax_loaders.load_csv_dataset(str(d), ["coarse", "fine"], text_col=text_col)
    assert ours == tuple(theirs)
    # the auto-detected text column is the first that is not a label: "id"
    assert (ours[0][0] == "0") == (text_col is None)


def test_load_csv_dataset_missing_column_and_file(tmp_path):
    d = _csv(tmp_path, False)
    for mod in (loaders, jax_loaders):
        with pytest.raises(ValueError, match="missing columns"):
            mod.load_csv_dataset(str(d), ["nope"])
        with pytest.raises(FileNotFoundError, match="git-LFS"):
            mod.load_csv_dataset(str(tmp_path / "absent"), ["fine"])


def test_empty_text_field_is_the_string_nan(tmp_path):
    """The rule of pandas < 3 that the JAX package's ``.astype(str)`` was
    written for; an empty label field is a float NaN, as pandas reads it."""
    d = tmp_path / "holes"
    d.mkdir()
    _write(d / "train.csv", ["text", "y"], [["some words", "a"], ["", "b"], ["more", "a"]])
    _write(d / "test.csv", ["text", "y"], [["NA", "b"]])
    docs, labels, n_train, n_val = loaders.load_csv_dataset(str(d), ["y"])
    assert docs == ["some words", "nan", "more", "nan"] and (n_train, n_val) == (3, 0)
    assert labels == [["a", "b", "a", "b"]]
    _write(d / "train.csv", ["text", "y"], [["w", "2"], ["v", ""]])
    _, labels, _, _ = loaders.load_csv_dataset(str(d), ["y"])
    assert labels[0][0] == 2.0 and np.isnan(labels[0][1])


def _jax_load_corpus(argv, levels):
    from common import load_corpus as jax_load_corpus

    return jax_load_corpus(jax_parse_config(argv), levels=levels)


@pytest.mark.parametrize("dataset", ["amazon", "dbpedia", "csv", "csv_val"])
def test_load_corpus_splits_match_jax(tmp_path, dataset):
    if dataset == "amazon":
        d, levels = _amazon(tmp_path), ["Cat1", "Cat2"]
    elif dataset == "dbpedia":
        d, levels = _dbpedia(tmp_path), ["l1", "l2", "l3"]
    else:
        d, levels = _csv(tmp_path, dataset == "csv_val"), ["coarse", "fine"]
    argv = ["--dataset", dataset.split("_")[0], "--data-dir", str(d), "--train-seed", "3"]
    cfg = parse_config(argv)
    check_ported(cfg)
    for lv in (levels, [levels[-1]]):
        ours = common.load_corpus(cfg, levels=lv)
        theirs = _jax_load_corpus(argv, lv)
        assert ours[0] == theirs[0]
        assert len(ours[1]) == len(theirs[1]) == len(lv)
        for o, t in zip(ours[1], theirs[1]):
            np.testing.assert_array_equal(o, t)
        np.testing.assert_array_equal(ours[2], theirs[2])
        np.testing.assert_array_equal(ours[3], theirs[3])


def test_csv_dataset_through_the_drivers(tmp_path):
    d = _csv(tmp_path, True)
    out = tmp_path / "rows.csv"
    base = ["--device", "cpu", "--dataset", "csv", "--data-dir", str(d), "--labels", "fine",
            "--text-col", "body", "--train-verbose", "0", "--graph-min-df", "1"]
    res = flat.main(base + ["--train-epochs", "5", "--result-file", str(out)])
    assert len(res["history"]) == 5 and np.isfinite([r["loss"] for r in res["history"]]).all()
    res = mlp_driver.main(base + ["--train-epochs", "5", "--levels", "coarse", "fine",
                                  "--hierarchy", "per-level"])
    assert len(res) == 2
    with pytest.raises(SystemExit, match="--data-dir"):
        flat.main(["--device", "cpu", "--dataset", "csv"])
