"""setup_s: process start to the first timed step: imports, the card,
the kernels' build or load, the inputs, the session and the warm-up."""


def read(rec):
    return rec.window.setup_s
