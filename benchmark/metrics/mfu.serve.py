"""The scorer's forward operations of the requests completed in the window
(valid frames only), over the window, as a share of the card's float32
peak."""

from benchmark import flops

UNIT = "%"


def read(run):
    rec = run.record
    if rec["kind"] != "serve" or not rec["lengths"]:
        return None
    ops = flops.model_forward(run.config, rec["lengths"])
    return 100.0 * ops / rec["window_s"] / run.peaks["f32_flops_per_s"]
