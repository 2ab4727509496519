"""vidsum_tpu_torch: the PyTorch + CUDA (H100) port of ``vidsum_tpu``.

This package imports ``torch``, ``numpy`` and ``scipy`` only; it never
imports ``jax`` or ``vidsum_tpu``. Its entry points run on the CUDA card
unless the caller passes ``device="cpu"``. Hand-written kernels live in
``csrc/`` and build at first use into ``_build/`` (``ops/_cuda.py``).

Slice 1 (this package so far) is the serving path: ``serve.ScoringService``
-> ``train.steps.make_eval_forward`` -> ``models.simnet.SimNet`` (the fused
block and flash-attention kernels) -> KTS + knapsack shot selection.
"""
