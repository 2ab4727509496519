"""95th percentile of submit -> ServeResult (shot selection included), in
ms, over every request completed in the window, from the clients' clock."""

import numpy as np

UNIT = "ms"


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not rec["latency_s"]:
        return None
    return float(np.percentile(np.asarray(rec["latency_s"]) * 1e3, 95))
