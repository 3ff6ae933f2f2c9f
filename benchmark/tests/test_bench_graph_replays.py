"""graph_replays_per_epoch on a small hand-written chrome trace: the
program's ``fit.replay`` spans that start in the traced window, over its
epochs."""

from benchmark import harness, tracing


def ev(name, ts, cat="user_annotation"):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": 1, "tid": 1, "pid": 1,
            "args": {}}


MARKS = [ev(tracing.EPOCH_MARK, t) for t in (100, 200, 300)]
# two epochs of a step's and an evaluation's replay; kineto's copies of the
# spans on the device's timeline, and a replay past the window's end
REPLAYS = [ev("fit.replay", base + ts) for base in (100, 200) for ts in (10, 60)]
COPIES = [ev("fit.replay", e["ts"], cat="gpu_user_annotation") for e in REPLAYS]
OUTSIDE = [ev("fit.replay", 350)]


def run(events):
    trace = None if events is None else tracing.TraceWindow(events)
    return harness.Run(config={}, traffic={}, n_nodes=1, n_edges=1, n_classes=1, setup_s=1.0,
                       epoch_s=[1e-4, 1e-4], timers={}, trace=trace)


def test_two_replays_an_epoch_read_two():
    read = harness.metric_reader("graph_replays_per_epoch")
    assert read(run(MARKS + REPLAYS + COPIES + OUTSIDE)) == 2.0


def test_no_replay_reads_nothing():
    read = harness.metric_reader("graph_replays_per_epoch")
    assert read(run(MARKS + OUTSIDE)) is None
    assert read(run(None)) is None
