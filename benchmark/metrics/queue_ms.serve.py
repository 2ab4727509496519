"""Mean host milliseconds of the program's ``serve.queue`` spans in the
traced window: a request from its enqueue to the start of its batch (the
queue, the batching window, batches of its window run before it)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "serve", "serve.queue")
