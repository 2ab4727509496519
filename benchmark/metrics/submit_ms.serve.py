"""Mean host milliseconds a client spends inside ``ScoringService.submit``
(admission, padding to the bucket, pinned staging, the copy's launch): the
benchmark's span around the call, over the window's completed requests."""

import numpy as np

UNIT = "ms"


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not rec["submit_s"]:
        return None
    return float(np.mean(rec["submit_s"]) * 1e3)
