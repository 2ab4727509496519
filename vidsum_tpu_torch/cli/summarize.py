# ported from vidsum_tpu/cli/summarize.py
"""Raw-video summarization CLI: one command from a video file to selected
frames (the end-to-end pipeline, ``vidsum_tpu_torch.pipeline``).

Usage:
    python -m vidsum_tpu_torch.cli.summarize --video clip.mp4 \\
        --ckpt model_mae.ckpt [--torch_ckpt model_mae.pth] \\
        --google_weights googlenet.pth --out summary.json

It runs on the CUDA card, at every d_model and head_dim the JAX package
takes; ``main(argv, device="cpu")`` runs the plain
PyTorch path (a keyword of the function, not a flag). The flags and their
defaults are the JAX package's. ``--ckpt`` takes a scorer checkpoint of
either package (the port's ``torch.save`` file or the JAX package's
msgpack), ``--torch_ckpt`` a reference-trained ``.pth``. ``--seq_shards N``
scores over a (1, N) ``parallel.mesh.DeviceMesh`` of the first N cards (the
ring) and exits when fewer are visible; on the CPU the N shards share it.
Decoding needs ``cv2``, resizing frames that are not already at ``--size``
needs PIL.
"""

from __future__ import annotations

import argparse
import json
import logging

from vidsum_tpu_torch.cli import add_arch_argument, scorer_config


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch summarize")
    p.add_argument("--video", required=True)
    p.add_argument("--ckpt", default=None,
                   help="scorer checkpoint of either package (the port's "
                        "torch.save file or the JAX package's msgpack)")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference-trained SimNet .pth (loaded as is)")
    p.add_argument("--google_weights", default=None,
                   help="torchvision googlenet state dict (.pth/.npz)")
    p.add_argument("--d_model", type=int, default=256)
    p.add_argument("--num_heads", type=int, default=4)
    p.add_argument("--num_layers", type=int, default=4)
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--size", type=int, default=224,
                   help="shorter-side resize for GoogLeNet input")
    p.add_argument("--budget", type=float, default=0.15)
    p.add_argument("--out", default="summary.json")
    p.add_argument("--seq_shards", type=int, default=1,
                   help="shard the frame sequence over this many cards "
                        "(ring attention) — for videos past one card's "
                        "attention")
    p.add_argument("--kts_impl", choices=("host", "device"), default="host",
                   help="'host' = float64 NumPy/C++ auto-KTS (the oracle), "
                        "'device' = the f32 DP on the card")
    p.add_argument("--stream_chunk", type=int, default=256,
                   help="frames per host->device chunk; each chunk ships "
                        "while later frames still decode (result is "
                        "chunk-invariant)")
    add_arch_argument(p)
    return p


def load_models(args, device=None):
    """(cfg, scorer, google) for ``args`` on ``device`` (default: the CUDA
    card): ``build_scorer(cfg)`` (``SimNet``, or ``PGLSum`` with ``--arch
    pglsum``) with the checkpoint's weights (or seeded random ones, with a
    warning) and the BN-folded ``GoogLeNet`` with ``--google_weights`` (or
    seeded random ones: features are then random projections)."""
    import torch

    from vidsum_tpu_torch.models import build_scorer
    from vidsum_tpu_torch.models.convert import load_torch_checkpoint
    from vidsum_tpu_torch.preprocess.extract import load_backbone
    from vidsum_tpu_torch.train.checkpoint import load_model_state

    cfg = scorer_config(args)
    scorer = build_scorer(cfg, device=device)
    if args.torch_ckpt:
        scorer.load_state_dict(load_torch_checkpoint(args.torch_ckpt))
    elif args.ckpt:
        scorer.load_state_dict(load_model_state(args.ckpt)[0])
    else:
        logging.warning("no checkpoint given — scoring with random weights")
    if not args.google_weights:
        logging.warning("no googlenet weights — features are random "
                        "projections")
    google = load_backbone("google", args.google_weights, device=device,
                           generator=torch.Generator().manual_seed(1))
    return cfg, scorer, google


def make_seq_mesh(n: int, device=None):
    """The (1, n) mesh of ``--seq_shards n``: the first n cards (a
    ``SystemExit`` when fewer are visible), or n shards of the CPU."""
    import torch

    from vidsum_tpu_torch.device import resolve_device
    from vidsum_tpu_torch.parallel.mesh import make_mesh

    dev = resolve_device(device)
    if dev.type != "cuda":
        return make_mesh((1, n), dev)
    if torch.cuda.device_count() < n:
        raise SystemExit(f"--seq_shards {n} but only "
                         f"{torch.cuda.device_count()} devices visible")
    return make_mesh((1, n), [f"cuda:{i}" for i in range(n)])


def main(argv=None, *, device=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    import numpy as np

    from vidsum_tpu_torch.pipeline import summarize_video

    if args.arch == "pglsum" and args.seq_shards > 1:
        raise SystemExit("--seq_shards runs SimNet's ring: PGL-SUM scores "
                         "on one device")
    mesh = make_seq_mesh(args.seq_shards, device) if args.seq_shards > 1 \
        else None
    cfg, scorer, google = load_models(args, device)
    result = summarize_video(args.video, scorer, cfg, google, fps=args.fps,
                             size=args.size, budget_ratio=args.budget,
                             mesh=mesh, kts_impl=args.kts_impl,
                             stream_chunk=args.stream_chunk, device=device)
    selected = np.nonzero(result.summary)[0].tolist()
    with open(args.out, "w") as f:
        json.dump({"video": args.video, "n_frames": int(result.n_frames),
                   "selected_frames": selected}, f)
    logging.info("selected %d / %d frames -> %s", len(selected),
                 result.n_frames, args.out)


if __name__ == "__main__":
    main()
