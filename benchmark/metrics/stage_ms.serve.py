"""Mean host milliseconds of the program's ``serve.stage`` spans in the
traced window: a client thread inside ``ScoringService.submit``, from entry
to the request's enqueue (validation, admission, padding to the bucket in
pinned memory, the copy's launch)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "serve.stage")
