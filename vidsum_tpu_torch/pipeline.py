# ported from vidsum_tpu/pipeline.py
"""End-to-end raw-video summarization on the card: pixels to a summary.

Decode on the host (OpenCV, :mod:`vidsum_tpu_torch.preprocess.reduce_fps`),
then on the device: normalisation, GoogLeNet pool5 over every sampled frame,
SimNet frame scores and the sigmoid; then KTS shot boundaries (float64 on
the host, or on the device with ``kts_impl="device"``) and the knapsack to
a binary summary. The reference needs three offline stages with h5 files in
between (``src/data/preprocess`` -> h5 -> ``src/train.py``'s val pass ->
``src/evaluation``); :func:`summarize_video` is the whole path.

Frames cross to the card as uint8 chunks of ``stream_chunk`` frames (pinned
host memory, asynchronous copies; the last chunk holds just the frames
left), and each chunk's GoogLeNet forward is queued as soon as its copy is,
so the card works while the host decodes the next chunk. The scorer is
``train/steps.make_eval_forward`` (the fused block kernels on CUDA, demoting
to the flash kernels past their envelope; the plain dense route on the CPU,
as the JAX package picks ``pallas_block`` / ``xla``), or with ``mesh`` the
sequence-parallel ring of ``parallel/seq_forward.py``.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.ops.kts import (
    change_points_from_cps, kts_segmentation, kts_segmentation_device,
)
from vidsum_tpu_torch.ops.summary import generate_summary
from vidsum_tpu_torch.parallel.seq_forward import make_seq_sharded_forward
from vidsum_tpu_torch.preprocess import reduce_fps as _rf
from vidsum_tpu_torch.preprocess.build_dataset import ACCEPTED_VIDEO_FORMATS
from vidsum_tpu_torch.preprocess.extract import embed
from vidsum_tpu_torch.preprocess.transforms import resize_shorter_side
from vidsum_tpu_torch.train.steps import make_eval_forward

# default sequence-padding granularity, shared by summarize_video and
# summarize_directory (the JAX package's)
_PAD_MULTIPLE = 64
# the fused block kernels take lengths in multiples of their 128-row tile
# (SimNet demotes other lengths to the flash kernels), so the single-device
# scorer's length also rounds up to it
_KERNEL_TILE = 128


@dataclasses.dataclass
class VideoSummary:
    summary: np.ndarray        # (n_frames,) binary frame selection
    scores: np.ndarray         # (n_picks,) sigmoid frame importance
    change_points: np.ndarray  # (S, 2) inclusive shot bounds (orig frames)
    picks: np.ndarray          # (n_picks,) original-frame indices
    n_frames: int


@dataclasses.dataclass
class _PendingVideo:
    """A video whose work is queued on the device but not fetched: the card
    keeps working while the host decodes the next video."""

    scores: torch.Tensor  # (T_pad,) sigmoid scores, on the device
    feats: torch.Tensor   # (n_real, 1024) f32 pool5 features, on the device
    n_real: int
    n_frames: int
    picks: np.ndarray


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def score_length(n_real: int, pad_multiple: int, mesh=None) -> int:
    """The scorer's padded length: ``n_real`` rounded up to
    ``pad_multiple``, times the mesh's ``seq`` size with a mesh (the ring
    pads each shard to its 64-key tile itself), or also to the kernels'
    128-row tile on one device."""
    if mesh is not None:
        return _round_up(n_real, pad_multiple * mesh.shape["seq"])
    return _round_up(_round_up(n_real, pad_multiple), _KERNEL_TILE)


def score_features(scorer: torch.nn.Module, cfg: ModelConfig,
                   feats: torch.Tensor, pad_multiple: int = _PAD_MULTIPLE,
                   mesh=None) -> torch.Tensor:
    """Sigmoid frame scores (T_pad,) of ``feats`` (n, in_features) on the
    scorer's device, the frames past n masked; not synchronised."""
    n_real = feats.shape[0]
    T = score_length(n_real, pad_multiple, mesh)
    x = feats.new_zeros((1, T, feats.shape[1]))
    x[0, :n_real] = feats
    pad_mask = (torch.arange(T, device=feats.device) >= n_real)[None]
    if mesh is None:
        fwd = make_eval_forward(cfg, device=feats.device)
        return fwd(scorer, x, pad_mask)[0]
    scores, _ = make_seq_sharded_forward(cfg, mesh)(scorer, x, pad_mask)
    return torch.sigmoid(scores[0, :, 0])


def _begin_video(video_path: str, scorer, cfg: ModelConfig, google, fps: int,
                 size: int, pad_multiple: int, mesh, stream_chunk: int,
                 dev: torch.device) -> _PendingVideo:
    """Decode -> resize -> chunked asynchronous copies, each chunk's
    features queued behind its copy -> the scorer queued. Returns without
    waiting for the device."""
    # looked up in the module at call time: the seam that tests and the
    # card (which has no cv2) replace with a stream of their own frames
    rs = _rf.iter_reduced_frames(video_path, fps=fps)
    chunk_mult = pad_multiple * (mesh.shape["seq"] if mesh is not None else 1)
    chunk = _round_up(max(stream_chunk, 1), chunk_mult)
    if rs.final_count:
        chunk = min(chunk, _round_up(rs.final_count, chunk_mult))
    feats: list = []
    buf: list = []

    def ship(frames):
        t = torch.from_numpy(np.stack(frames))
        if dev.type == "cuda":
            t = t.pin_memory()
        feats.append(embed(google, "google",
                           t.to(dev, non_blocking=True)))

    n_real = 0
    try:
        for f in rs.frames:
            buf.append(resize_shorter_side(f, size))
            n_real += 1
            if len(buf) == chunk:
                ship(buf)
                buf = []
    finally:
        rs.close()  # release the decoder even if a resize or stack raises
    if buf:
        ship(buf)
    if n_real == 0:
        raise ValueError(f"no frames decoded from {video_path}")
    all_feats = torch.cat(feats)
    return _PendingVideo(
        scores=score_features(scorer, cfg, all_feats, pad_multiple, mesh),
        feats=all_feats, n_real=n_real, n_frames=rs.n_frames,
        picks=rs.picks(n_real))


def shot_bounds(feats: torch.Tensor, kts_impl: str = "host") -> np.ndarray:
    """Auto-KTS change points (pick coordinates) of a video's features
    (n, 1024): ``"host"`` is the float64 NumPy / C++ DP (the oracle),
    ``"device"`` the f32 DP on the features' device
    (:func:`~vidsum_tpu_torch.ops.kts.kts_segmentation_device`).

    The device route centres the features before the Gram. A window's
    scatter is the sum of its features' squared distances to their mean,
    which a shift of every feature leaves as it is, so the DP's exact
    arithmetic is unchanged; but pool5 features share a large common
    component (norms ~184 against scene distances ~3.5 with seeded
    weights), and the f32 cumulative sums of the raw Gram lose the scenes
    to rounding (19 shots found for 11 planted at 480 frames, 96 for 39 at
    2,400), where the centred Gram keeps the host's. The Gram's f32
    product keeps PyTorch's default of no TF32 on the card."""
    n = feats.shape[0]
    ncp = max(n // 25, 1)
    if kts_impl == "device":
        f = feats.float()
        f = f - f.mean(dim=0)
        cps_pad, m_best, _ = kts_segmentation_device(f @ f.T, ncp, vmax=1.0)
        return cps_pad.cpu().numpy()[: int(m_best)]
    if kts_impl != "host":
        raise ValueError(f"kts_impl must be 'host' or 'device', got "
                         f"{kts_impl!r}")
    f64 = feats.cpu().numpy().astype(np.float64)
    cps, _ = kts_segmentation(f64 @ f64.T, ncp, vmax=1.0)
    return cps


def _finish_video(p: _PendingVideo, budget_ratio: float,
                  kts_impl: str) -> VideoSummary:
    """Fetch the pending results and select shots (KTS + knapsack)."""
    n_real = p.n_real
    scores = p.scores[:n_real].float().cpu().numpy()
    cps = shot_bounds(p.feats, kts_impl)
    bounds = change_points_from_cps(cps, n_real)
    ratio = p.n_frames / n_real
    starts = np.round(bounds[:, 0] * ratio).astype(np.int64)
    ends = np.concatenate([starts[1:] - 1, [p.n_frames - 1]])
    change_points = np.stack([starts, ends], axis=1)

    [summary] = generate_summary([change_points], [scores], [p.n_frames],
                                 [p.picks], budget_ratio=budget_ratio)
    return VideoSummary(summary=summary, scores=scores,
                        change_points=change_points, picks=p.picks,
                        n_frames=p.n_frames)


def summarize_video(video_path: str, scorer, cfg: ModelConfig, google,
                    fps: int = 2, size: int = 224, budget_ratio: float = 0.15,
                    pad_multiple: int = _PAD_MULTIPLE, mesh=None,
                    kts_impl: str = "host", stream_chunk: int = 256, *,
                    device=None) -> VideoSummary:
    """Raw video file -> binary summary, on ``device`` (default: the CUDA
    card), where ``scorer`` (a ``SimNet``) and ``google`` (a ``GoogLeNet``)
    must live.

    :param mesh: a :class:`~vidsum_tpu_torch.parallel.mesh.DeviceMesh` with
        (data, seq) axes: the scorer then runs sequence-parallel with the
        exact ring, so no N x N tensor exists; the features are computed per
        frame on ``device`` and the padding rounds up to ``seq x
        pad_multiple``.
    :param kts_impl: ``"host"`` (float64 auto-KTS, the oracle) or
        ``"device"`` (:func:`~vidsum_tpu_torch.ops.kts.
        kts_segmentation_device` on the features while they are on the
        card).
    :param stream_chunk: frames per host-to-device chunk (rounded up to the
        padding multiple). Scores do not depend on the chunking: padded
        frames are masked throughout.
    """
    dev = resolve_device(device)
    pending = _begin_video(video_path, scorer, cfg, google, fps, size,
                           pad_multiple, mesh, stream_chunk, dev)
    return _finish_video(pending, budget_ratio, kts_impl)


def summarize_directory(video_dir: str, scorer, cfg: ModelConfig, google,
                        out_json: str = "summary.json", fps: int = 2,
                        size: int = 224, budget_ratio: float = 0.15,
                        stream_chunk: int = 256, *,
                        device=None) -> Dict[str, list]:
    """Run the raw-video pipeline over every video in a directory and write a
    ``summary.json`` keyed by ``video_<i>`` (the reference's export layout,
    ``src/generate_summary_image.py:39-48``).

    Two-deep: video i+1 decodes (and its chunks' work is queued) while video
    i's is still on the card, then i is fetched and its shots selected. The
    results are those of sequential :func:`summarize_video` calls."""
    dev = resolve_device(device)
    results: Dict[str, list] = {}
    paths = sorted(p for p in glob.glob(os.path.join(video_dir, "*"))
                   if p.rsplit(".", 1)[-1].lower() in ACCEPTED_VIDEO_FORMATS)
    pending: Optional[tuple] = None

    def finish(entry):
        j, p = entry
        out = _finish_video(p, budget_ratio, "host")
        results[f"video_{j}"] = np.nonzero(out.summary)[0].tolist()

    for i, path in enumerate(paths):
        nxt = _begin_video(path, scorer, cfg, google, fps, size,
                           _PAD_MULTIPLE, None, stream_chunk, dev)
        if pending is not None:
            finish(pending)
        pending = (i, nxt)
    if pending is not None:
        finish(pending)
    with open(out_json, "w") as f:
        json.dump(results, f, indent=8)
    return results
