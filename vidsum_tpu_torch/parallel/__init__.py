# ported from vidsum_tpu/parallel/__init__.py
from vidsum_tpu_torch.parallel.mesh import DeviceMesh, make_mesh, rotate
from vidsum_tpu_torch.parallel.distributed import (
    DistributedConfig, global_mesh, init_distributed, is_coordinator,
    put_batch,
)
from vidsum_tpu_torch.parallel.sharding import block_shard
from vidsum_tpu_torch.parallel.dp_shardmap import (
    make_dp_shardmap_finetune_step,
)
from vidsum_tpu_torch.parallel.train_parallel import (
    make_sharded_finetune_step, make_sharded_pretrain_step,
)
from vidsum_tpu_torch.parallel.ring_attention import (
    make_ring_forward, ring_attention, ring_attention_train,
)
from vidsum_tpu_torch.parallel.seq_forward import (
    make_seq_sharded_finetune_step, make_seq_sharded_forward,
)
from vidsum_tpu_torch.parallel.pipeline import (
    make_pp_forward, make_pp_train_step, stack_blocks,
)

__all__ = [
    "DeviceMesh", "make_mesh", "rotate", "block_shard",
    "make_dp_shardmap_finetune_step", "make_sharded_finetune_step",
    "make_sharded_pretrain_step", "ring_attention", "make_ring_forward",
    "ring_attention_train", "make_seq_sharded_forward",
    "make_seq_sharded_finetune_step", "make_pp_forward",
    "make_pp_train_step", "stack_blocks", "DistributedConfig",
    "init_distributed", "is_coordinator", "global_mesh", "put_batch",
]
