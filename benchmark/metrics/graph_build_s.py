"""graph_build_s: ``Text2Graph.fit_transform`` on the cell's corpus, in s
(host clock; the graph build runs on the host)."""


def read(run):
    return run.timers.get("graph_build_s")
