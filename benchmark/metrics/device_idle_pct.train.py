"""Share of the traced window in which no operation (kernel, copy, memset)
ran on the card."""

UNIT = "%"


def read(run):
    tr = run.trace
    if tr is None or run.record["kind"] != "train" or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
