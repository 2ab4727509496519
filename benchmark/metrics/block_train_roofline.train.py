"""The block training kernels' share of their roofline (TPU kernels 9-12,
``csrc/block_train.cu`` with its attention from ``attention_core.cuh``):
the least time the card needs for the encoder blocks' forward and backward
over the traced steps' valid frames (float32 peak), over the device time of
those kernels in the trace."""

from benchmark import flops
from benchmark.trace import kernel_seconds

UNIT = "%"
KERNELS = [r"(^|::)bt_",
           r"(^|::)fma_(fwd|dq|dkdv)(_sliced)?_kernel"]


def read(run):
    rec, tr = run.record, run.trace
    if tr is None or rec["kind"] != "train" or not rec["traced_steps"]:
        return None
    busy = kernel_seconds(tr, KERNELS)
    if busy <= 0.0:
        return None
    least = (flops.block_train(run.config, rec["traced_lengths"])
             / run.peaks["f32_flops_per_s"])
    return 100.0 * least / busy
