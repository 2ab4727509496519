# ported from vidsum_tpu/cli/pretrain.py
"""Pretrain CLI, flag-compatible with the reference's ``src/pretrain.py``
and the JAX package's CLI.

Reference: ``src/pretrain.py:90-131``. The flags and defaults are the JAX
package's; ``--momentum`` is accepted and unused, as there. Pretraining runs
on the CUDA card; ``main(argv, device="cpu")`` runs the plain PyTorch path
(a keyword of the function, not a flag). The card takes every d_model and
head_dim the JAX package takes.

Usage (the ``run_pretrain.sh`` recipe):
    python -m vidsum_tpu_torch.cli.pretrain --data data/features \\
        --d_model 256 --num_heads 4 --num_layers 4 --dropout 0.2 --lr 1e-3 \\
        --epochs 200 --batch_size 256 --sparsity 0.0

``--data`` holds ``frames/*.npy`` and ``video/*.npy`` (numpy only), or with
``--from_h5`` the DSNet ``.h5`` files and ``video/<dataset>/<key>.npy``
(read with ``h5py``).
"""

from __future__ import annotations

import argparse
import logging

from vidsum_tpu_torch.config import (
    Config, DataConfig, ModelConfig, PretrainConfig,
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch pretrain")
    p.add_argument("--data", required=True, type=str)
    p.add_argument("--datasets", default="tvsum+summe+ovp+youtube", type=str)
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--use_pos", type=bool, default=True)
    p.add_argument("--num_layers", type=int, default=3)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--sparsity", type=float, default=0.0,
                   help="positional-encoding dropout (the reference wires "
                        "sparsity there, simnet.py:201-203)")
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--momentum", type=float, default=0.9,
                   help="accepted for reference compatibility; unused there "
                        "too (pretrain.py:111)")
    p.add_argument("--weight_decay", type=float, default=5e-4)
    p.add_argument("--epochs", type=int, default=50)
    p.add_argument("--save", type=str, default=".")
    p.add_argument("--from_h5", action="store_true",
                   help="read features from DSNet h5 files "
                        "(PreTrainDatasetReady) instead of frames/*.npy")
    p.add_argument("--length_bucket", type=int, default=128)
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--resume", action="store_true",
                   help="restart from pretrain_state.ckpt in --save, "
                        "written by either package (parameters and Adam "
                        "state; the reference's pretrain.pth is weight-only)")
    p.add_argument("--save_every", type=int, default=1,
                   help="checkpoint cadence in epochs (1 = the reference's; "
                        "the last epoch always saves)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection: raise at the "
                        "first backward that makes a NaN")
    return p


def config_from_args(args) -> Config:
    return Config(
        model=ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                          num_layers=args.num_layers, dropout=args.dropout,
                          use_pos=args.use_pos, pos_dropout=args.sparsity,
                          compute_dtype=args.compute_dtype),
        data=DataConfig(root=args.data, datasets=args.datasets,
                        length_bucket=args.length_bucket),
        pretrain=PretrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                                batch_size=args.batch_size,
                                epochs=args.epochs,
                                save_every=args.save_every),
    )


def main(argv=None, *, device=None) -> dict:
    """Parse ``argv``, load the dataset and run ``train.pretraining.
    pretrain`` on ``device`` (default: the CUDA card). Returns its result."""
    args = build_parser().parse_args(argv)
    # a multi-process launch joins its process group first (a no-op
    # otherwise; parallel/distributed.py)
    from vidsum_tpu_torch.parallel.distributed import init_distributed

    init_distributed()
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    import torch

    from vidsum_tpu_torch.data.datasets import (
        PreTrainDataset, PreTrainDatasetReady,
    )
    from vidsum_tpu_torch.device import resolve_device
    from vidsum_tpu_torch.train.pretraining import pretrain

    dev = resolve_device(device)
    cfg = config_from_args(args)
    if args.from_h5:
        dataset = PreTrainDatasetReady(args.data, args.datasets)
    else:
        dataset = PreTrainDataset(args.data)
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        return pretrain(cfg, dataset, workdir=args.save, resume=args.resume,
                        device=dev)


if __name__ == "__main__":
    main()
