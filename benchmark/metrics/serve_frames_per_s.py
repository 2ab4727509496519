"""Feature rows of every request completed in the window, over the
window."""

UNIT = "frames/s"


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not rec["lengths"]:
        return None
    return float(sum(rec["lengths"])) / rec["window_s"]
