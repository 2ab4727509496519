"""Mean host milliseconds of the program's ``train.transfer`` spans in the
traced window: the training step moving its host batch to the card (a
pageable copy, which waits for the stream to reach it)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "train", "train.transfer")
