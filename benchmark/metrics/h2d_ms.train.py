"""Device milliseconds of host-to-device copies per step in the traced part
of the window (the step moves its host batch to the card)."""

UNIT = "ms"


def read(run):
    rec, tr = run.record, run.trace
    if (tr is None or rec["kind"] != "train" or not rec["traced_steps"]
            or tr["h2d_s"] <= 0):
        return None
    return 1e3 * tr["h2d_s"] / rec["traced_steps"]
