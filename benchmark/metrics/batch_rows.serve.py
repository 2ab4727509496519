"""Real request rows per device batch over the window (``ServeStats``:
``rows_scored / batches``)."""

UNIT = "rows"


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not rec["batches"]:
        return None
    return rec["rows_scored"] / rec["batches"]
