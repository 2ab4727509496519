"""The serving attention's share of its roofline: the least time the card
needs for the attention of the requests sent and finished inside the traced
part of the window (float32 peak, valid queries x keys), over the device
time of the attention kernels in that trace. The float32 serving attention
of every route (fused block and flash) runs ``attention_core.cuh``'s
forward kernel."""

from benchmark import flops
from benchmark.trace import kernel_seconds

UNIT = "%"
KERNELS = [r"(^|::)fma_fwd(_sliced)?_kernel"]


def read(run):
    rec, tr = run.record, run.trace
    if tr is None or rec["kind"] != "serve" or not rec["traced_lengths"]:
        return None
    busy = kernel_seconds(tr, KERNELS)
    if busy <= 0.0:
        return None
    least = (flops.attention_forward(run.config, rec["traced_lengths"])
             / run.peaks["f32_flops_per_s"])
    return 100.0 * least / busy
