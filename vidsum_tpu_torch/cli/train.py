# ported from vidsum_tpu/cli/train.py
"""Finetune CLI, flag-compatible with the reference's ``src/train.py`` and
the JAX package's CLI.

Reference: ``src/train.py:168-215``. The flags and defaults are the JAX
package's (its ``--lr`` default is the launch recipe's 1e-3, not the
reference's literal 1e5). Training runs on the CUDA card; ``main(argv,
device="cpu")`` runs the plain PyTorch path (a keyword of the function, not
a flag). On the card, head_dim (d_model / num_heads) must be at most 128
and d_model at most 1,024. ``--eval_impl device`` builds the val pass's
summaries on the card (``ops/device_eval.py``; the same frames as the host
oracle). ``--dp`` trains over a ``MeshConfig(data=-1, model=--tp)`` mesh
of the visible cards (``train.finetune.finetune(mesh=)``; on a one-card
machine a (1, 1) mesh, where ``--tp 2`` raises the JAX divisibility error).
A multi-process run sets ``VIDSUM_COORDINATOR`` (process 0's host:port),
``VIDSUM_NUM_PROCESSES`` and ``VIDSUM_PROCESS_ID`` in each process's
environment (``parallel/distributed.py``).

Usage:
    python -m vidsum_tpu_torch.cli.train --data data --datasets tvsum \\
        --ex_dataset tvsum --batch_size 4 --num_heads 4 --d_model 256 \\
        --num_layers 4 --lr 1e-3 --weight_decay 1e-4 --max_epoch 100 \\
        --dsnet_split --use_model

Reading the DSNet ``.h5`` files needs ``h5py``; a ``.yaml`` split file needs
``yaml``.
"""

from __future__ import annotations

import argparse
import json
import logging

from vidsum_tpu_torch.config import (
    Config, DataConfig, EvalConfig, ModelConfig, TrainConfig,
)
from vidsum_tpu_torch.data.splits import builtin_split_path, load_splits

CARD_LIMITS = "on the CUDA card head_dim = d_model / num_heads <= 128"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch finetune")
    p.add_argument("--num_heads", default=4, type=int,
                   help=f"attention heads ({CARD_LIMITS})")
    p.add_argument("--d_model", default=256, type=int,
                   help=f"model width (at most 1,024 on the CUDA card; "
                        f"{CARD_LIMITS})")
    p.add_argument("--num_layers", default=4, type=int)
    p.add_argument("--dropout", default=0.3, type=float)
    p.add_argument("--lr", default=1e-3, type=float)
    p.add_argument("--weight_decay", default=1e-4, type=float)
    p.add_argument("--data", type=str, required=True,
                   help="path to *.h5 data folder (read with h5py)")
    p.add_argument("--ex_dataset", type=str, default="tvsum")
    p.add_argument("--datasets", type=str, default="tvsum")
    p.add_argument("--batch_size", default=4, type=int)
    p.add_argument("--max_epoch", default=200, type=int)
    p.add_argument("--name", default="", type=str)
    p.add_argument("--use_model", action="store_true",
                   help="warm-start from the pretrain checkpoint "
                        "(workdir/pretrain.ckpt, either package's format)")
    p.add_argument("--save", action="store_true")
    p.add_argument("--dsnet_split", action="store_true")
    p.add_argument("--split_path", type=str, default=None,
                   help="explicit split file (.json/.yaml); overrides "
                        "--dsnet_split resolution")
    p.add_argument("--workdir", type=str, default=".")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--length_bucket", type=int, default=128)
    p.add_argument("--resume", action="store_true",
                   help="continue from train_state.ckpt (parameters and "
                        "Adam state; the reference cannot resume)")
    p.add_argument("--metrics", type=str, default=None,
                   help="append per-epoch JSONL records here")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler trace (trace.json) of the first "
                        "epoch")
    p.add_argument("--dp", action="store_true",
                   help="train dp(xtp) over all visible cards")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree within the mesh (with --dp)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection: raise at the "
                        "first backward that makes a NaN")
    p.add_argument("--eval_impl", type=str, default="host",
                   choices=("host", "device"),
                   help="summary pipeline for val epochs: 'host' = the "
                        "NumPy/C++ pipeline (default), 'device' = one "
                        "batched pass on the card (the same frames)")
    p.add_argument("--state_save_every", type=int, default=1,
                   help="save the full resume state every K epochs; the "
                        "last epoch of a split always saves")
    p.add_argument("--model_save_every", type=int, default=1,
                   help="save the weight-only model checkpoint every K "
                        "epochs (reference saves every epoch, train.py:95); "
                        "the last epoch of a split always saves")
    return p


def config_from_args(args) -> Config:
    return Config(
        model=ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                          num_layers=args.num_layers, dropout=args.dropout,
                          compute_dtype=args.compute_dtype),
        data=DataConfig(root=args.data, ex_dataset=args.ex_dataset,
                        datasets=args.datasets,
                        length_bucket=args.length_bucket),
        eval=EvalConfig(impl=args.eval_impl),
        train=TrainConfig(lr=args.lr, weight_decay=args.weight_decay,
                          batch_size=args.batch_size,
                          max_epoch=args.max_epoch,
                          use_pretrained=args.use_model,
                          state_save_every=args.state_save_every,
                          model_save_every=args.model_save_every),
    )


def main(argv=None, *, device=None) -> None:
    """Parse ``argv`` and finetune on ``device`` (default: the CUDA card;
    with ``--dp`` the mesh's entries are the visible cards, or ``device``
    itself where one is given)."""
    args = build_parser().parse_args(argv)
    # a multi-process launch (VIDSUM_NUM_PROCESSES > 1) joins its process
    # group first; a no-op otherwise (parallel/distributed.py)
    from vidsum_tpu_torch.parallel.distributed import init_distributed

    init_distributed()
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    if args.split_path:
        splits = load_splits(args.split_path)
    elif args.dsnet_split:
        # the reference hardcodes splits_dsnet/tvsum.yaml whatever
        # --ex_dataset says (train.py:208); here the file follows it
        splits = load_splits(builtin_split_path(args.ex_dataset))
    else:
        raise SystemExit("provide --dsnet_split or --split_path")
    cfg = config_from_args(args)
    import torch

    from vidsum_tpu_torch.train.finetune import finetune

    mesh = None
    if args.dp:
        from vidsum_tpu_torch.config import MeshConfig
        from vidsum_tpu_torch.parallel.distributed import global_mesh

        mesh = global_mesh(MeshConfig(data=-1, model=args.tp), device)
        device = None
    with torch.autograd.set_detect_anomaly(args.debug_nans):
        result = finetune(cfg, splits, workdir=args.workdir,
                          resume=args.resume, metrics_path=args.metrics,
                          profile_dir=args.profile_dir, mesh=mesh,
                          device=device)
    print(json.dumps({"fscore": result.fscore,
                      "kendall_tau": result.kendall_tau,
                      "spearman_rho": result.spearman_rho}))


if __name__ == "__main__":
    main()
