"""Mean host milliseconds until the training step call returns, without a
synchronise: the batch's host-to-device copy and the launches of the
forward, backward and optimizer (the benchmark's span around the call)."""

import numpy as np

UNIT = "ms"


def read(run):
    rec = run.record
    if rec["kind"] != "train" or not rec["enqueue_s"]:
        return None
    return float(np.mean(rec["enqueue_s"]) * 1e3)
