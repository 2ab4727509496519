# ported from vidsum_tpu/ops/device_eval.py
"""Summary generation on the device (``eval_impl="device"``).

One batched program over a padded video axis runs the whole summary
pipeline of ``src/evaluation/generate_summary.py:6-57`` on the card: score
upsampling (a gather through ``searchsorted``, no arithmetic), the mean
importance of every shot, the 0/1-knapsack DP over shots
(:func:`vidsum_tpu_torch.ops.knapsack.knapsack_device`, a per-video budget
inside a shared table width) and the binary frame summary. The JAX package
runs it as one jitted, vmapped XLA program per shape bucket; here it is one
sequence of batched PyTorch ops over the same buckets, so a whole val set
is one pass and one fetch.

Parity contract: the host pipeline (``ops/summary.py``, the float64 NumPy /
C++ DP) is the oracle, and this path selects its frames bit for bit:

- shot values replicate numpy's float32 summation order exactly for shots
  of <= 128 frames (8 accumulators over the full blocks, the fixed combine
  tree, the sequential tail), which is every real KTS shot; longer shots
  take a float64 sum rounded once to float32 (the JAX package's double-float
  sum, which the TPU needs for want of float64);
- the knapsack table is float64 with the host DP's adds and compares;
- the budget is rounded on the host in float64 (``int((end+1)*ratio)``,
  ``generate_summary.py:46``) and passed in.

Videos that break the DSNet-shaped input contract (:func:`device_eligible`)
go to the host oracle instead.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from vidsum_tpu_torch.device import resolve_device
from vidsum_tpu_torch.ops.knapsack import knapsack_device
from vidsum_tpu_torch.ops.summary import generate_summary

_INT_MAX = np.iinfo(np.int32).max
_EXACT_SHOT = 128   # longest shot whose value replicates numpy's f32 sum


def _bucket(n: int, step: int = 128) -> int:
    return max(step, -(-n // step) * step)


def device_eligible(picks: np.ndarray, scores: np.ndarray,
                    n_frames: int) -> bool:
    """True when a video meets the device path's DSNet-shaped contract:
    ``picks`` strictly increasing (the upsampling is a ``searchsorted``), one
    score per pick (the host zero-fills past ``len(scores)`` with a
    loop-order rule), and ``n_frames`` past the last pick. Every real DSNet
    h5 meets all three; the rest go to the host oracle."""
    picks = np.asarray(picks).reshape(-1)
    if len(picks) == 0 or len(np.asarray(scores).reshape(-1)) != len(picks):
        return False
    if not bool(np.all(picks[1:] > picks[:-1])):
        return False
    return int(np.asarray(n_frames).reshape(())) > int(picks[-1])


def _numpy_f32_sums(vals: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """numpy's float32 ``sum`` of each row's first ``lengths`` entries for
    lengths <= 128 (``vals`` (..., 128), zero past the length): under 8 a
    sequential sum; from 8 on, 8 accumulators over the full 8-blocks, the
    fixed combine tree, then the sequential tail. Adding an exact 0.0 for
    the masked entries leaves every partial sum's rounding as it is, so one
    masked construction covers every length."""
    m_full = lengths - lengths % 8
    blocks = vals.reshape(*vals.shape[:-1], 16, 8)
    r = vals.new_zeros((*vals.shape[:-1], 8))
    zero = vals.new_zeros(())
    for b in range(16):
        r = r + torch.where((8 * b < m_full)[..., None], blocks[..., b, :],
                            zero)
    total = (((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3]))
             + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7])))
    for p in range(8):
        pos = (m_full + p).clamp(0, _EXACT_SHOT - 1)
        tail = torch.gather(vals, -1, pos[..., None])[..., 0]
        total = total + torch.where(m_full + p < lengths, tail, zero)
    return total


def _summaries(scores, picks, n_picks, cps, n_shots, n_frames, budget,
               F: int, W: int) -> torch.Tensor:
    """The summary program over a padded video axis: (V, P) scores and
    picks, (V,) counts, (V, S, 2) shot bounds, (V,) frames and budgets ->
    (V, F) int8 summaries."""
    dev = scores.device
    V, P = scores.shape
    S = cps.shape[1]
    # upsample (compute_metrics.py:19-39): frame f takes scores[j], j the
    # pick segment holding f; 0 past the last pick
    pos = torch.where(torch.arange(P, device=dev)[None] < n_picks[:, None],
                      picks, _INT_MAX)
    f_idx = torch.arange(F, device=dev).expand(V, F).contiguous()
    j = torch.searchsorted(pos, f_idx, right=True) - 1
    valid = (f_idx < n_frames[:, None]) & (j >= 0) & (j < n_picks[:, None])
    frame_scores = torch.where(
        valid, torch.gather(scores, 1, j.clamp(0, P - 1)),
        scores.new_zeros(()))

    # per-shot mean importance (generate_summary.py:37-42)
    starts = cps[..., 0].clamp(0, F - 1)
    ends = cps[..., 1].clamp(0, F - 1)
    shot_valid = torch.arange(S, device=dev)[None] < n_shots[:, None]
    lengths = torch.where(shot_valid, ends - starts + 1, 0)
    k_idx = torch.arange(_EXACT_SHOT, device=dev)
    gather = (starts[..., None] + k_idx).clamp(0, F - 1).reshape(V, -1)
    vals = torch.where(k_idx < lengths[..., None],
                       torch.gather(frame_scores, 1, gather).reshape(
                           V, S, _EXACT_SHOT),
                       scores.new_zeros(()))
    csum = torch.nn.functional.pad(torch.cumsum(frame_scores.double(), 1),
                                   (1, 0))
    long_sum = (torch.gather(csum, 1, ends + 1)
                - torch.gather(csum, 1, starts)).float()
    sums = torch.where(lengths <= _EXACT_SHOT,
                       _numpy_f32_sums(vals, lengths), long_sum)
    values = torch.where(shot_valid,
                         sums / lengths.clamp(min=1).to(torch.float32),
                         scores.new_zeros(()))

    # 0/1 knapsack (knapsack_implementation.py:1-30)
    taken = knapsack_device(W, lengths, values, budget) & shot_valid

    # binary frame summary (generate_summary.py:50-55): +1 at a taken shot's
    # start, -1 past its end, a running sum > 0
    edges = torch.zeros((V, F + 1), dtype=torch.int32, device=dev)
    one = taken.to(torch.int32)
    edges.scatter_add_(1, starts, one)
    edges.scatter_add_(1, ends + 1, -one)
    return (torch.cumsum(edges, 1)[:, :F] > 0).to(torch.int8)


def device_generate_summary(all_shot_bound: Sequence[np.ndarray],
                            all_scores: Sequence[np.ndarray],
                            all_nframes: Sequence[int],
                            all_positions: Sequence[np.ndarray],
                            budget_ratio: float = 0.15, *,
                            device=None) -> List[np.ndarray]:
    """The device counterpart of
    :func:`vidsum_tpu_torch.ops.summary.generate_summary` (same arguments and
    returns), on ``device`` (default: the CUDA card, which must exist).

    Every video is padded to dataset-wide buckets (multiples of 128 for
    picks and frames, 16 for shots, 256 for the table width, 8 for the video
    axis, as in the JAX package) and all run as one batched pass with one
    fetch. Videos outside :func:`device_eligible`'s contract take the host
    oracle, so the composed result is always the host's."""
    V = len(all_shot_bound)
    if V == 0:
        return []
    dev = resolve_device(device)
    shot_bounds = [np.asarray(sb, np.int64) for sb in all_shot_bound]
    positions = [np.asarray(p).astype(np.int64).reshape(-1)
                 for p in all_positions]
    scores = [np.asarray(s, np.float32).reshape(-1) for s in all_scores]
    n_frames = [int(np.asarray(n).reshape(())) for n in all_nframes]

    good = [v for v in range(V)
            if device_eligible(positions[v], scores[v], n_frames[v])]
    out: List[np.ndarray] = [None] * V  # type: ignore[list-item]
    bad = sorted(set(range(V)) - set(good))
    if bad:
        host = generate_summary([all_shot_bound[v] for v in bad],
                                [all_scores[v] for v in bad],
                                [all_nframes[v] for v in bad],
                                [all_positions[v] for v in bad],
                                budget_ratio=budget_ratio)
        for v, s in zip(bad, host):
            out[v] = s
    if not good:
        return out

    final_ends = [int(shot_bounds[v][-1, 1]) for v in good]
    # float64 budget rounding on the host, like the reference (:46)
    budgets = [int((fe + 1) * budget_ratio) for fe in final_ends]
    P = _bucket(max(len(positions[v]) for v in good))
    F = _bucket(max(max(n_frames[v], fe + 1)
                    for v, fe in zip(good, final_ends)))
    S = _bucket(max(len(shot_bounds[v]) for v in good), 16)
    W = _bucket(max(budgets), 256)
    Vb = _bucket(len(good), 8)

    pos_pad = np.full((Vb, P), _INT_MAX, np.int64)
    sc_pad = np.zeros((Vb, P), np.float32)
    cp_pad = np.zeros((Vb, S, 2), np.int64)
    n_picks = np.zeros((Vb,), np.int64)
    n_shots = np.zeros((Vb,), np.int64)
    nf_arr = np.zeros((Vb,), np.int64)
    bud_arr = np.zeros((Vb,), np.int64)
    for i, v in enumerate(good):
        pos_pad[i, : len(positions[v])] = positions[v]
        sc_pad[i, : len(scores[v])] = scores[v]
        cp_pad[i, : len(shot_bounds[v])] = shot_bounds[v]
        n_picks[i] = len(positions[v])
        n_shots[i] = len(shot_bounds[v])
        nf_arr[i] = n_frames[v]
        bud_arr[i] = budgets[i]

    args = [torch.from_numpy(a).to(dev, non_blocking=True)
            for a in (sc_pad, pos_pad, n_picks, cp_pad, n_shots, nf_arr,
                      bud_arr)]
    summaries = _summaries(*args, F=F, W=W).cpu().numpy()   # one fetch
    for i, (v, fe) in enumerate(zip(good, final_ends)):
        out[v] = summaries[i, : fe + 1]
    return out
