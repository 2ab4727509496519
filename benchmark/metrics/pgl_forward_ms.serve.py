"""Mean host milliseconds of the program's ``pglsum.forward`` spans in the
traced window: the dispatcher from a batch on the card to its forward's
last launch (the PGL-SUM scorer's launches, without the wait for the
card)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "pglsum.forward")
