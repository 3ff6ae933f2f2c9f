"""plan_build_s: ``Trainer.prepare`` (``NormAdj.from_graph``: the
normalisation and the CSR kernel's plans, copied to the card), in s, host
clock ending in a synchronize."""


def read(run):
    return run.timers.get("plan_build_s")
