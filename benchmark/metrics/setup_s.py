"""Set-up seconds: from the start of the process to the first timed step or
request (model, weights, traffic pool, kernel builds and loads, warm-up)."""

UNIT = "s"


def read(run):
    return run.setup_s
