"""vidsum_tpu_torch: the PyTorch + CUDA (H100) port of ``vidsum_tpu``.

This package imports ``torch``, ``numpy`` and ``scipy`` only; it never
imports ``jax`` or ``vidsum_tpu``. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``. Hand-written kernels live in
``csrc/`` and build at first use into ``_build/`` (``ops/_cuda.py``).

The slices ported so far: the serving path (``serve.ScoringService`` ->
``train.steps.make_eval_forward`` -> ``models.simnet.SimNet``, the fused
block and flash-attention kernels -> KTS + knapsack shot selection); the
finetune step and long-video training (``train.steps.make_finetune_step``,
``ops.block_train``, ``ops.attention_train``); and int8 scoring served over
HTTP (``cli.serve`` -> ``serve_http`` -> the int8 wire and ``SimNet``'s
int8 route, ``ops.quant`` and ``ops.block_kernel_int8``), with the
int8-against-bf16 product probe ``tools.probe_int8_mma``.
"""
