# ported from vidsum_tpu/cli/build_dataset.py
"""Dataset-builder CLI: raw videos + annotations -> DSNet-schema h5.

Replaces the reference's import-time ``make_dataset.py`` execution
(``src/data/preprocess/make_dataset.py:182``) with an explicit command. The
backbones run on the CUDA card; ``main(argv, device="cpu")`` runs them on the
CPU. Decoding needs ``cv2``, resizing PIL, the h5 writer ``h5py`` (imported
where they are used).

Usage:
    python -m vidsum_tpu_torch.cli.build_dataset \\
        --videos path/to/videos --out data/summarizer_dataset_tvsum_google_pool5.h5 \\
        --annotations path/to/ydata-tvsum50.mat --dataset tvsum \\
        --fps 2 --seg kts --google_weights googlenet.pth --r3d_weights r3d18.pth
"""

from __future__ import annotations

import argparse
import logging


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("vidsum_tpu_torch dataset builder")
    p.add_argument("--videos", required=True, help="directory of video files")
    p.add_argument("--out", required=True, help="output .h5 path")
    p.add_argument("--annotations", default=None,
                   help="TVSum .mat file or SumMe GT directory")
    p.add_argument("--dataset", choices=["tvsum", "summe", "none"],
                   default="none", help="annotation format")
    p.add_argument("--fps", type=int, default=2)
    p.add_argument("--seg", choices=["kts", "uniform"], default="kts")
    p.add_argument("--google_weights", default=None,
                   help="torchvision googlenet state dict (.pth/.npz)")
    p.add_argument("--r3d_weights", default=None)
    p.add_argument("--video_rep_dir", default=None,
                   help="also write R3D-18 video embeddings here "
                        "(enables pretraining data)")
    p.add_argument("--tar", default=None,
                   help="also write the reference's packaging artifact "
                        "(annotations pickle + features/video/*.npy in a "
                        ".tar.gz — make_dataset.py:109-130)")
    return p


def main(argv=None, *, device=None) -> None:
    args = build_parser().parse_args(argv)
    logging.basicConfig(format="[%(levelname)s] %(module)s - %(message)s",
                        level=logging.INFO)
    annotations = None
    if args.annotations and args.dataset == "tvsum":
        from vidsum_tpu_torch.preprocess.annotations import (
            read_tvsum_annotations,
        )
        annotations = read_tvsum_annotations(args.annotations)
    elif args.annotations and args.dataset == "summe":
        from vidsum_tpu_torch.preprocess.annotations import (
            read_summe_annotations,
        )
        annotations = read_summe_annotations(args.annotations)

    from vidsum_tpu_torch.preprocess.build_dataset import build_dataset
    n = build_dataset(
        args.videos, args.out, annotations=annotations, fps=args.fps,
        seg_mode=args.seg, google_weights=args.google_weights,
        r3d_weights=args.r3d_weights,
        with_video_rep=args.video_rep_dir is not None,
        video_rep_dir=args.video_rep_dir, tar_path=args.tar, device=device)
    logging.info("wrote %d videos to %s", n, args.out)


if __name__ == "__main__":
    main()
