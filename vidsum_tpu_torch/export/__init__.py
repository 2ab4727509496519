# ported from vidsum_tpu/export/__init__.py
"""Port of the corresponding vidsum_tpu subpackage: the summary JSON, the
attention maps and the frame images."""

from vidsum_tpu_torch.export.attention import (
    collect_attention_weights, save_attention_weights,
)
from vidsum_tpu_torch.export.frames import (
    generate_video_frames, reduce_fps_and_save,
)
from vidsum_tpu_torch.export.summary_json import (
    summaries_for_dataset, write_summary_json,
)

__all__ = [
    "write_summary_json", "summaries_for_dataset",
    "collect_attention_weights", "save_attention_weights",
    "generate_video_frames", "reduce_fps_and_save",
]
