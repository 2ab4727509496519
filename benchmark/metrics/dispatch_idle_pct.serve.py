"""Share of the traced window the serving dispatcher spent blocked on an
empty queue (the program's ``serve.idle`` spans): in single-card serving
the dispatcher is the card's only feeder, so this is how much of the idle
card is a starved dispatcher."""

from benchmark.program_spans import durations_ms

UNIT = "%"


def read(run):
    ms = durations_ms(run, "serve", "serve.idle")
    if ms is None:
        return None
    return 100.0 * sum(ms) / 1e3 / run.trace["window_s"]
