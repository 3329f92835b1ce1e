"""setup_s: from the start of the process to the start of the window:
imports, the card, the build or load of the kernels and the host library,
the inputs made from the seed, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
