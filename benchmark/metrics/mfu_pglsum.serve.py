"""PGL-SUM's forward operations of the requests completed in the window
(valid rows only, ``flops_pglsum``), over the window, as a share of the
card's float32 peak."""

from benchmark import flops_pglsum

UNIT = "%"


def read(run):
    rec = run.record
    if (rec["kind"] != "serve" or not rec["lengths"]
            or run.config.get("arch") != "pglsum"):
        return None
    ops = flops_pglsum.model_forward(run.config, rec["lengths"])
    return 100.0 * ops / rec["window_s"] / run.peaks["f32_flops_per_s"]
