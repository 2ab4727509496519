"""Mean host milliseconds of the program's ``train.compute`` spans in the
traced window: the rest of the training step, without a synchronise
(zero_grad, the launches of forward, losses, backward and Adam)."""

from benchmark.program_spans import mean_ms

UNIT = "ms"


def read(run):
    return mean_ms(run, "train", "train.compute")
