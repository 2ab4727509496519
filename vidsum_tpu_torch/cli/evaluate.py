# ported from vidsum_tpu/cli/evaluate.py
"""Standalone evaluation CLI: checkpoint + dataset -> F-score / tau / rho.

The reference couples evaluation into the train loop (``src/train.py:134``);
this scores a saved model on any split without training. ``--ckpt`` takes a
checkpoint of either package (the port's ``torch.save`` file or the JAX
package's msgpack file, told apart by their first bytes), ``--torch_ckpt`` a
reference-trained ``.pth``. ``--attn`` keeps the JAX package's choices and
maps them to the port's routes: ``xla`` -> ``dense``, ``pallas`` ->
``flash``, ``pallas_block`` -> ``fused_block``. Scoring runs on the CUDA
card, at every d_model and head_dim the JAX package takes; ``main(argv,
device="cpu")`` runs the plain path. Reading the
``.h5`` files needs ``h5py``.

Usage:
    python -m vidsum_tpu_torch.cli.evaluate --data data --ex_dataset tvsum \\
        --ckpt model_mae.ckpt [--torch_ckpt model_mae.pth] \\
        [--split_path splits.json --fold 0] [--attn pallas_block]
"""

from __future__ import annotations

import argparse
import json
import logging

ATTN_ROUTES = {"xla": "dense", "pallas": "flash",
               "pallas_block": "fused_block"}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch evaluate")
    p.add_argument("--data", required=True,
                   help="path to *.h5 data folder (read with h5py)")
    p.add_argument("--ex_dataset", default="tvsum")
    p.add_argument("--ckpt", default=None,
                   help="model checkpoint of either package")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference-trained SimNet .pth")
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--split_path", default=None,
                   help="evaluate only the fold's test_keys")
    p.add_argument("--fold", type=int, default=0)
    p.add_argument("--eval_method", default="avg", choices=["avg", "max"])
    p.add_argument("--attn", default="xla",
                   choices=["xla", "pallas", "pallas_block"],
                   help="xla -> the dense route, pallas -> flash, "
                        "pallas_block -> fused_block")
    p.add_argument("--compute_dtype", default="float32",
                   choices=["float32", "bfloat16"])
    return p


def main(argv=None, *, device=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    from vidsum_tpu_torch.config import (
        Config, DataConfig, EvalConfig, ModelConfig,
    )
    from vidsum_tpu_torch.data.datasets import TSDataset
    from vidsum_tpu_torch.data.splits import load_splits
    from vidsum_tpu_torch.device import resolve_device
    from vidsum_tpu_torch.models.convert import load_torch_checkpoint
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.train.checkpoint import load_model_state
    from vidsum_tpu_torch.train.finetune import _val_epoch
    from vidsum_tpu_torch.train.steps import make_eval_forward

    dev = resolve_device(device)
    mcfg = ModelConfig(d_model=args.d_model, num_heads=args.num_heads,
                       num_layers=args.num_layers,
                       compute_dtype=args.compute_dtype)
    cfg = Config(model=mcfg, data=DataConfig(root=args.data,
                                             ex_dataset=args.ex_dataset),
                 eval=EvalConfig(eval_method=args.eval_method))
    if args.torch_ckpt:
        state = load_torch_checkpoint(args.torch_ckpt)
    elif args.ckpt:
        state, _ = load_model_state(args.ckpt)
    else:
        raise SystemExit("provide --ckpt or --torch_ckpt")
    model = SimNet(mcfg, device=dev)
    model.load_state_dict(state)

    keys = None
    if args.split_path:
        keys = load_splits(args.split_path)[args.fold]["test_keys"]
    val_set = TSDataset(args.data, args.ex_dataset, args.ex_dataset,
                        keys=keys, split="val")
    fwd = make_eval_forward(mcfg, attn_impl=ATTN_ROUTES[args.attn],
                            device=dev)
    val_loss, f, k, s = _val_epoch(fwd, model, val_set, cfg)
    print(json.dumps({"val_loss": val_loss, "fscore": f, "kendall_tau": k,
                      "spearman_rho": s}))


if __name__ == "__main__":
    main()
