"""word_edges_s: the newest ``graph.word_edges`` stage of the program, in s
(``build/text2graph.py::Text2Graph.fit_transform``: the word-word edges'
windows, co-occurrence counting and PMI; ``time.perf_counter``), read from
``train/profiling.py::stages`` in the run's own process. A program without
stages reads nothing."""

from benchmark.metrics.csr_plan_s import newest_stage_s


def read(run):
    return newest_stage_s("graph.word_edges")
