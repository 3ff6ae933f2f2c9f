"""CSV dataset loaders for the reference's two benchmark datasets.

Port of ``pytextgcn_tpu/data/loaders.py``. Amazon product reviews (columns
Text, Cat1, Cat2, [Cat3]) and DBpedia (columns text, l1, l2, l3) — schemas
per SURVEY.md §2.5 and the reference's loading code (flat_amazon.py:42-43,
flat_dbpedia.py:41-47) — and the generic ``--dataset csv``. The CSVs are not
shipped with the reference (git-LFS); these loaders work when a user drops
the files into ``data/``.

The JAX package reads the files with pandas; the port reads them with the
standard library's ``csv`` module and types each column as pandas'
``read_csv`` does by default, because label encoding sorts the values:
a column whose every field is an integer holds ints (labels ``2, 10``
encode as ``0, 1``, where strings would sort ``"10"`` first), one whose
fields are all numbers or empty holds floats with NaN for the empty ones,
any other column holds strings with NaN for the empty ones. pandas' default
missing-value tokens (``""``, ``"NA"``, ``"nan"``, ``"null"``, ...) count
as empty.
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# pandas.read_csv's default na_values
_NA_TOKENS = frozenset([
    "", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN", "-nan", "1.#IND",
    "1.#QNAN", "<NA>", "N/A", "NA", "NULL", "NaN", "None", "n/a", "nan", "null",
])
_INT_RE = re.compile(r"[+-]?\d+")
_FLOAT_RE = re.compile(r"[+-]?(\d+\.?\d*|\.\d+)([eE][+-]?\d+)?|[+-]?(inf|Inf|INF)")


def _typed_column(fields: List[str]) -> list:
    """One column's fields as pandas types them: all integers -> int; all
    numbers or missing -> float (NaN for missing); else str (NaN for
    missing)."""
    present = [f for f in fields if f not in _NA_TOKENS]
    if len(present) == len(fields) and present and all(_INT_RE.fullmatch(f) for f in present):
        return [int(f) for f in fields]
    if present and all(_FLOAT_RE.fullmatch(f) for f in present):
        return [math.nan if f in _NA_TOKENS else float(f) for f in fields]
    return [math.nan if f in _NA_TOKENS else f for f in fields]


def _read_csv(path: str) -> Dict[str, list]:
    """Column name -> typed values, in file order; blank lines skipped."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"{path} not found — the reference datasets are distributed via "
            "git-LFS and must be supplied manually (SURVEY.md §2.5)."
        )
    with open(path, newline="", encoding="utf-8") as f:
        rows = [r for r in csv.reader(f) if r]
    if not rows:
        raise ValueError(f"{path} is empty")
    header, body = rows[0], rows[1:]
    for i, r in enumerate(body):
        if len(r) != len(header):
            raise ValueError(f"{path}: row {i + 1} has {len(r)} fields, the header "
                             f"{len(header)}")
    return {name: _typed_column([r[j] for r in body]) for j, name in enumerate(header)}


def load_amazon(
    data_dir: str = "data/amazon", label: str = "Cat2"
) -> Tuple[list, list, list, list]:
    """Returns (x_train, y_train, x_test, y_test) raw text/labels."""
    train = _read_csv(os.path.join(data_dir, "train.csv"))
    test = _read_csv(os.path.join(data_dir, "test.csv"))
    return train["Text"], train[label], test["Text"], test[label]


def load_dbpedia(
    data_dir: str = "data/dbpedia", label: str = "l3"
) -> Tuple[list, list, list, list, list, list]:
    """Returns (x_train, y_train, x_val, y_val, x_test, y_test)."""
    train = _read_csv(os.path.join(data_dir, "DBPEDIA_train.csv"))
    val = _read_csv(os.path.join(data_dir, "DBPEDIA_val.csv"))
    test = _read_csv(os.path.join(data_dir, "DBPEDIA_test.csv"))
    return (train["text"], train[label], val["text"], val[label], test["text"],
            test[label])


def encode_labels(*label_lists: Sequence) -> Tuple[np.ndarray, ...]:
    """LabelEncoder-equivalent: map labels to ints by sorted order, fit over
    the concatenation (flat_amazon.py:63 semantics)."""
    all_labels = sorted({l for ls in label_lists for l in ls})
    table = {l: i for i, l in enumerate(all_labels)}
    return tuple(np.array([table[l] for l in ls], dtype=np.int32) for ls in label_lists)


def _as_text(v) -> str:
    """``Series.astype(str)`` of one value, as pandas < 3 gives it: a
    missing field is the string ``"nan"``."""
    return v if isinstance(v, str) else str(v)


def load_csv_dataset(
    data_dir: str,
    label_cols: Sequence[str],
    text_col: Optional[str] = None,
) -> Tuple[List[str], List[list], int, int]:
    """Generic CSV dataset: ``data_dir/train.csv`` + ``test.csv`` and an
    optional ``val.csv``, each holding one text column and the requested
    label columns (``--dataset csv --data-dir ... --labels <col>
    [--text-col <col>]``).

    ``text_col=None`` auto-detects: 'text' or 'Text' if present, else the
    first column that is not a label column. Returns
    ``(docs, per_level_raw_labels, n_train, n_val)`` with docs concatenated
    train [+ val] + test (transductive, like the reference drivers);
    ``n_val = 0`` when there is no val.csv (callers draw a random split,
    amazon-style). An empty text field gives the document ``"nan"``, the
    rule of pandas < 3 that the JAX package's ``.astype(str)`` was written
    for (pandas 3 keeps a float NaN there).
    """
    train = _read_csv(os.path.join(data_dir, "train.csv"))
    test = _read_csv(os.path.join(data_dir, "test.csv"))
    val_path = os.path.join(data_dir, "val.csv")
    val = _read_csv(val_path) if os.path.exists(val_path) else None

    if text_col is None:
        for cand in ("text", "Text"):
            if cand in train:
                text_col = cand
                break
        else:
            others = [c for c in train if c not in set(label_cols)]
            if not others:
                raise ValueError(
                    f"no text column found in {data_dir}/train.csv "
                    f"(columns: {list(train)}); pass text_col"
                )
            text_col = others[0]
    frames = [train] + ([val] if val is not None else []) + [test]
    for f in frames:
        missing = [c for c in [text_col, *label_cols] if c not in f]
        if missing:
            raise ValueError(
                f"CSV in {data_dir} is missing columns {missing} (have: {list(f)})"
            )
    docs = [_as_text(v) for f in frames for v in f[text_col]]
    labels = [[l for f in frames for l in f[col]] for col in label_cols]
    n_rows = lambda f: len(f[text_col])
    return docs, labels, n_rows(train), (n_rows(val) if val is not None else 0)
