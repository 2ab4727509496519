"""Mean host milliseconds of the program's ``serve.batch`` spans in the
traced window: the dispatcher from assembling a batch to its scores on the
host (stack, forward launches, the wait for the card, the copy back)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "serve.batch")
