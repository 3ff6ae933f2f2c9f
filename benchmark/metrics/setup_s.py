"""setup_s: process start to the start of the timed window, in s: imports,
corpus, graph build, parameters, operator build, the first epochs (which
build the kernels on a checkout's first run) and the card's warm-up."""


def read(run):
    return run.setup_s
