# ported from vidsum_tpu/parallel/__init__.py (the sequence-parallel ring;
# data, tensor and pipeline parallelism arrive with the multi-GPU slice)
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, rotate
from vidsum_tpu_torch.parallel.ring_attention import (
    make_ring_forward, ring_attention, ring_attention_train,
)
from vidsum_tpu_torch.parallel.seq_forward import (
    make_seq_sharded_finetune_step, make_seq_sharded_forward,
)

__all__ = [
    "DeviceMesh", "make_mesh", "rotate", "ring_attention",
    "make_ring_forward", "ring_attention_train",
    "make_seq_sharded_forward", "make_seq_sharded_finetune_step",
]
