"""The model operations of the window's training steps (forward and
backward over the valid frames, ``flops.train_step``), over the window, as
a share of the card's float32 peak."""

from benchmark import flops

UNIT = "%"


def read(run):
    rec = run.record
    if rec["kind"] != "train" or not rec["steps"]:
        return None
    ops = flops.train_step(run.config, rec["lengths"], rec["pretrain"])
    return 100.0 * ops / rec["window_s"] / run.peaks["f32_flops_per_s"]
