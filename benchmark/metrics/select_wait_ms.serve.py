"""Mean host milliseconds of the program's ``serve.select_wait`` spans in
the traced window: a request from its scores on the host to a selection
worker starting on it."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "serve.select_wait")
