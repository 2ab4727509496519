"""Mean host milliseconds of the program's ``serve.select`` spans in the
traced window: a selection worker from taking a request to setting its
future (shot scores, the knapsack, the result)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "serve.select")
