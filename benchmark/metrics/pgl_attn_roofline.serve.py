"""PGL-SUM's attention's share of its roofline: the least time the card
needs for the global and local attention of the requests sent and finished
inside the traced part of the window (``flops_pglsum.attention_forward``:
valid queries x keys, float32 peak), over the device time of the
position-biased attention kernel in that trace. The bias's sines and
cosines are computed in the kernel and not counted as work."""

from benchmark import flops_pglsum
from benchmark.trace import kernel_seconds

UNIT = "%"
KERNELS = [r"(^|::)fma_fwd_posbias_kernel"]


def read(run):
    rec, tr = run.record, run.trace
    if (tr is None or rec["kind"] != "serve" or not rec["traced_lengths"]
            or run.config.get("arch") != "pglsum"):
        return None
    busy = kernel_seconds(tr, KERNELS)
    if busy <= 0.0:
        return None
    least = (flops_pglsum.attention_forward(run.config, rec["traced_lengths"])
             / run.peaks["f32_flops_per_s"])
    return 100.0 * least / busy
