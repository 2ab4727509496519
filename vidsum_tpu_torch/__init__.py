"""vidsum_tpu_torch: the PyTorch + CUDA (H100) port of ``vidsum_tpu``.

This package imports ``torch``, ``numpy`` and ``scipy`` only; it never
imports ``jax`` or ``vidsum_tpu``. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``. Hand-written kernels live in
``csrc/`` and build at first use into ``_build/`` (``ops/_cuda.py``).

The slices ported so far: the serving path (``serve.ScoringService`` ->
``train.steps.make_eval_forward`` -> ``models.simnet.SimNet``, the fused
block and flash-attention kernels -> KTS + knapsack shot selection); the
finetune step and long-video training (``train.steps.make_finetune_step``,
``ops.block_train``, ``ops.attention_train``); int8 scoring served over
HTTP (``cli.serve`` -> ``serve_http`` -> the int8 wire and ``SimNet``'s
int8 route, ``ops.quant`` and ``ops.block_kernel_int8``), with the
int8-against-bf16 product probe ``tools.probe_int8_mma``; sequence-parallel
long videos (``parallel``); the finetune protocol (``cli.train`` ->
``train.finetune.finetune`` over ``data.datasets.TSDataset``, checkpoints in
``train.checkpoint`` that also read the JAX package's msgpack files and
resume from its state files, ``cli.evaluate`` and ``cli.serve --ckpt``);
self-supervised pretraining (``cli.pretrain`` -> ``train.pretraining.
pretrain`` -> ``models.pretrain.PretrainModel`` and the pretrain losses of
``ops.losses``); the serving CLI's worker-recycling supervisor
(``cli.serve --recycle_after_mb / --recycle_after_requests``); and the
raw-video path (``cli.summarize`` -> ``pipeline.summarize_video``: frames
decoded by ``preprocess.reduce_fps``, GoogLeNet pool5 from
``preprocess.googlenet``, the scorer, KTS and the knapsack; the offline
``preprocess`` stage and ``cli.build_dataset``) with shot selection on the
card (``ops.kts.kts_segmentation_device``, ``ops.knapsack.knapsack_device``,
``ops.device_eval``, ``eval_impl="device"``).
"""
