"""Corpus -> TextGraph transformer.

The port of ``pytextgcn_tpu/build/text2graph.py``, a counterpart of the
reference's ``Text2GraphTransformer`` (textgcn/lib/text2graph.py:49-247):
same knobs (min_df, max_df, window_size, rm_stopwords, max_length,
save_path), same graph (TF-IDF doc-word edges both directions, PMI
word-word edges, node-id layout words < docs, masks with word rows excluded
from train, word-node pseudo-labels). The edge arrays are bitwise equal to
the JAX package's on the same corpus. Everything here runs on the host:
numpy/scipy plus the native C++ kernels in ``native/``.
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core.graph import TextGraph
from .stopwords import get_stopwords
from .vectorizer import CountVectorizer, TfidfTransform
from .windows import word_word_edges


class Text2Graph:
    def __init__(
        self,
        min_df: Union[int, float] = 5,
        window_size: int = 20,
        save_path: Optional[str] = None,
        n_jobs: Optional[int] = None,
        max_df: Union[int, float] = 1.0,
        verbose: int = 0,
        rm_stopwords: bool = True,
        max_length: Optional[int] = None,
        backend: str = "auto",
        device=None,
    ):
        """Parameter set mirrors the reference (text2graph.py:50-52);
        ``sparse_features`` is gone because features are always implicit, and
        ``backend`` selects the word-word counting kernel
        ('auto'/'native'/'device'/'sharded'/'oracle'; see
        :func:`.windows.word_word_edges`), and ``device`` where 'device'
        counting runs (None = the GPU; resolved only when it runs) and
        'sharded' counting spreads (None: every visible card).

        ``n_jobs``: thread count for the native counting kernel. The
        reference documents this knob but never uses it (graphbuilder.pyx:36);
        here ``n_jobs >= 1`` pins exactly that many threads (sklearn-style:
        ``n_jobs=1`` really is single-threaded) and the default ``None``
        keeps the kernel's own choice (hardware concurrency) — counting is
        embarrassingly parallel over documents, so there is no reason to
        serialize it by default."""
        if not min_df > 0:
            raise ValueError(f"min_df must be positive, got {min_df!r}")
        self.min_df = min_df
        self.max_df = max_df
        self.window_size = window_size
        self.save_path = save_path
        self.n_jobs = n_jobs
        self.verbose = verbose
        self.rm_stopwords = rm_stopwords
        self.max_length = max_length
        self.backend = backend
        self.device = device
        self.cv: Optional[CountVectorizer] = None
        self.tfidf_: Optional[TfidfTransform] = None
        self.n_docs_: Optional[int] = None
        self.n_vocabs_: Optional[int] = None
        self.counts_ = None  # sparse doc-term counts (for MLP baselines)
        self.tfidf_mat_ = None  # sparse TF-IDF (for MLP baselines)

    def _log(self, level: int, msg: str) -> None:
        if self.verbose >= level:
            print(msg, flush=True)

    def fit_transform(
        self,
        X: Union[List[str], str],
        y=None,
        test_idx=None,
        val_idx=None,
        hierarchy_feats=None,
    ) -> TextGraph:
        """Build the word/document graph over the corpus.

        X: list of documents, or a directory path whose *.txt files are read
        (matching text2graph.py:120-128). y: per-document labels.
        test_idx/val_idx: document indices (document-local, as in the
        reference; node ids are offset by n_vocab internally).
        hierarchy_feats: optional [n_docs, F] float features appended as
        extra columns on document rows (text2graph.py:226-246).
        """
        t0 = time.time()
        if isinstance(X, str):
            import glob

            self._log(1, f"Loading input from {X}")
            docs = []
            for f in sorted(glob.glob(os.path.join(X, "*.txt"))):
                with open(f) as fp:
                    docs.append(fp.read())
        else:
            docs = list(X)

        stop = get_stopwords("nltk") if self.rm_stopwords else None
        self.cv = CountVectorizer(min_df=self.min_df, max_df=self.max_df, stop_words=stop)
        counts = self.cv.fit_transform(docs)
        self.counts_ = counts
        n_docs, n_vocab = counts.shape
        self.n_docs_, self.n_vocabs_ = n_docs, n_vocab
        self._log(2, f"Number of documents in input: {n_docs}")
        self._log(2, f"Vocabulary size: {n_vocab}")

        tokens = self.cv.encode_documents(docs, self.max_length)
        self._log(1, "Building doc-word edges...")
        self.tfidf_ = TfidfTransform()
        tfidf = self.tfidf_.fit_transform(counts).tocoo()
        self.tfidf_mat_ = tfidf.tocsr()
        # th.nonzero order is row-major (text2graph.py:148); scipy coo from
        # csr is also row-major sorted.
        dw_doc = tfidf.row.astype(np.int32)
        dw_word = tfidf.col.astype(np.int32)
        dw_w = tfidf.data.astype(np.float32)

        self._log(1, "Building word-word edges...")
        ww_coo, ww_w, n_windows = word_word_edges(
            tokens, n_vocab, self.window_size, backend=self.backend,
            n_jobs=self.n_jobs or 0,  # None -> 0 = hardware concurrency
            device=self.device,
        )
        self._log(2, f"Number of word-word-edges: {len(ww_w)} ({n_windows} windows)")

        # assemble: [word-word, doc->word, word->doc] exactly like
        # text2graph.py:162-171 (docs offset by n_vocab).
        src = np.concatenate([ww_coo[:, 0], dw_doc + n_vocab, dw_word])
        dst = np.concatenate([ww_coo[:, 1], dw_word, dw_doc + n_vocab])
        w = np.concatenate([ww_w, dw_w, dw_w]).astype(np.float32)

        n_nodes = n_docs + n_vocab
        test_mask = np.zeros(n_nodes, dtype=bool)
        val_mask = np.zeros(n_nodes, dtype=bool)
        if test_idx is not None:
            test_mask[np.asarray(test_idx, dtype=np.int64) + n_vocab] = True
        if val_idx is not None:
            val_mask[np.asarray(val_idx, dtype=np.int64) + n_vocab] = True
        train_mask = ~(test_mask | val_mask)
        train_mask[:n_vocab] = False
        y_nodes = np.zeros(n_nodes, dtype=np.int32)
        if y is not None:
            y_nodes[n_vocab:] = np.asarray(y, dtype=np.int32)

        hf = None
        if hierarchy_feats is not None:
            hf = np.asarray(hierarchy_feats, dtype=np.float32)
            if hf.shape[0] != n_docs:
                raise ValueError("hierarchy_feats must be [n_docs, F]")

        g = TextGraph(
            edge_src=src.astype(np.int32),
            edge_dst=dst.astype(np.int32),
            edge_w=w,
            y=y_nodes,
            train_mask=train_mask,
            val_mask=val_mask,
            test_mask=test_mask,
            n_vocab=int(n_vocab),
            n_docs=int(n_docs),
            hierarchy_feats=hf,
            # PMI edges are emitted in both directions with equal weight
            # and doc<->word edges carry the same TF-IDF both ways
            # (text2graph.py:162-171) — construction-guaranteed symmetry
            weight_symmetric=True,
        )
        self._log(1, f"total edge count is {g.n_edges} (built in {time.time() - t0:.2f}s)")

        if self.save_path is not None:
            os.makedirs(self.save_path, exist_ok=True)
            savefile = os.path.join(self.save_path, f"TGData_{time.time()}.npz")
            self._log(1, f"saving to {savefile}")
            g.save(savefile)
        return g

    @staticmethod
    def load_graph(path: str) -> TextGraph:
        if not os.path.exists(path) and not os.path.exists(path + ".npz"):
            raise FileNotFoundError("Given file does not exist!")
        return TextGraph.load(path)

    @property
    def vocabulary(self) -> Dict[str, int]:
        """word -> vocabulary index (text2graph.py:219-224)."""
        if self.cv is None:
            raise RuntimeError("call fit_transform first")
        return self.cv.vocabulary_
