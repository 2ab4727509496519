# ported from vidsum_tpu/ops/kts.py
"""Kernel Temporal Segmentation (KTS): change-point detection by DP over a
frame-similarity Gram matrix.

Behaviour (reference: ``src/data/preprocess/segmentations/kts/``):
- :func:`calc_scatters` (``cpd_nonlin.py:5-24``): the scatter of every
  [i, j] window from cumulative sums of the kernel matrix, one vectorized
  float64 expression with the reference's per-element arithmetic.
- :func:`cpd_nonlin` (``cpd_nonlin.py:27-91``): the DP
  ``I[k, l] = min_t I[k-1, t] + J[t, l-1]`` with segment-length bounds
  [lmin, lmax], sentinel costs 1e101/1e100 and earliest-t tie-breaking,
  plus backtracking.
- :func:`kts_segmentation` (``cpd_auto.py:5-47``): auto-select the
  change-point count by the penalized cost
  ``scores/N + (vmax·ncp/2N)(log(N/ncp)+1)``.
- :func:`calc_scatters_device` / :func:`cpd_nonlin_device` /
  :func:`kts_segmentation_device`: the same DP on tensors, on the tensor's
  device and in its dtype (the raw-video pipeline's ``kts_impl="device"``);
  the float64 host path stays the oracle.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from vidsum_tpu_torch import native

# the C++ fast paths; set to None to force NumPy
_calc_scatters_native = native.calc_scatters_native
_cpd_dp_native = native.cpd_dp_native

_HUGE_INIT = 1e101   # "untouched" sentinel (cpd_nonlin.py:62)
_HUGE = 1e100        # "no valid split" sentinel (cpd_nonlin.py:72)


def calc_scatters(K: np.ndarray, use_native: bool = True) -> np.ndarray:
    """scatters[i, j] = unnormalized variance of frames [i..j] (upper tri)."""
    K = np.asarray(K, dtype=np.float64)
    n = K.shape[0]
    if _calc_scatters_native is not None and use_native and native.available():
        return _calc_scatters_native(K)
    K1 = np.concatenate([[0.0], np.cumsum(np.diag(K))])
    K2 = np.zeros((n + 1, n + 1))
    K2[1:, 1:] = np.cumsum(np.cumsum(K, 0), 1)

    i = np.arange(n)[:, None]
    j = np.arange(n)[None, :]
    diag_sum = K1[1:][None, :] - K1[:n][:, None]             # K1[j+1]-K1[i]
    block_sum = (np.diag(K2)[1:][None, :] + np.diag(K2)[:n][:, None]
                 - K2[1:, :n].T - K2[:n, 1:])                # K2[j+1,j+1]+K2[i,i]-K2[j+1,i]-K2[i,j+1]
    with np.errstate(divide="ignore", invalid="ignore"):
        scatters = diag_sum - block_sum / (j - i + 1)
    return np.where(j >= i, scatters, 0.0)


def cpd_nonlin(K: np.ndarray, ncp: int, lmin: int = 1, lmax: int = 100000,
               backtrack: bool = True,
               scatters: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Best ``ncp`` change points by DP. Returns (cps, objective values).

    ``scores[k]`` is the optimal objective using k change points (inf when
    infeasible), matching the reference's returned ``I[:, n]`` with >1e99
    mapped to inf.
    """
    m = int(ncp)
    n, n1 = K.shape
    if n != n1:
        raise ValueError("Kernel matrix awaited.")
    if not (n >= (m + 1) * lmin and n <= (m + 1) * lmax
            and lmax >= lmin >= 1):
        raise ValueError(f"infeasible segmentation: n={n}, ncp={m}, "
                         f"lmin={lmin}, lmax={lmax}")

    J = calc_scatters(K) if scatters is None else scatters

    if _cpd_dp_native is not None and native.available():
        cps, scores = _cpd_dp_native(np.asarray(J, np.float64), m,
                                     lmin=lmin, lmax=lmax)
        return (cps if backtrack else np.zeros(m, dtype=int)), scores

    I = _HUGE_INIT * np.ones((m + 1, n + 1))
    I[0, lmin:lmax] = J[0, lmin - 1:lmax - 1]

    p = np.zeros((m + 1, n + 1), dtype=int)

    t_idx = np.arange(n + 1)
    for k in range(1, m + 1):
        # cand[t, l] = I[k-1, t] + J[t, l-1] for l in 1..n, t in 0..n-1
        cand = I[k - 1, :n, None] + J[:, :]  # J[t, l-1] → column l-1
        # valid t range for column l: max(k*lmin, l-lmax) <= t <= l-lmin
        l_vals = np.arange(1, n + 1)[None, :]
        t_vals = t_idx[:n, None]
        valid = (t_vals >= np.maximum(k * lmin, l_vals - lmax)) & \
                (t_vals <= l_vals - lmin)
        cand = np.where(valid, cand, np.inf)
        best = cand.min(axis=0)
        argbest = cand.argmin(axis=0)
        improved = best < _HUGE
        # columns with an empty t-range but l >= (k+1)*lmin get the 1e100
        # sentinel; columns below (k+1)*lmin stay untouched at 1e101.
        touched = l_vals[0] >= (k + 1) * lmin
        I[k, 1:][touched] = np.where(improved[touched], best[touched], _HUGE)
        if backtrack:
            p[k, 1:][touched & improved] = argbest[touched & improved]

    cps = np.zeros(m, dtype=int)
    if backtrack:
        cur = n
        for k in range(m, 0, -1):
            cps[k - 1] = p[k, cur]
            cur = cps[k - 1]

    scores = I[:, n].copy()
    scores[scores > 1e99] = np.inf
    return cps, scores


def kts_segmentation(K: np.ndarray, ncp: int, vmax: float, desc_rate: int = 1,
                     **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """Auto-select the change-point count, then backtrack the best
    segmentation (reference: ``cpd_auto.py:5-47``). Returns (cps, penalized
    costs for 0..ncp change points)."""
    m = int(ncp)
    J = calc_scatters(np.asarray(K, dtype=np.float64))
    _, scores = cpd_nonlin(K, m, backtrack=False, scatters=J, **kwargs)

    N = K.shape[0]
    N2 = N * desc_rate
    penalties = np.zeros(m + 1)
    ncps = np.arange(1, m + 1)
    penalties[1:] = (vmax * ncps / (2.0 * N2)) * (np.log(float(N2) / ncps) + 1)

    costs = scores / float(N) + penalties
    m_best = int(np.argmin(costs))
    cps, _ = cpd_nonlin(K, m_best, scatters=J, **kwargs)
    return cps, costs


def change_points_from_cps(cps: np.ndarray, n_frames: int) -> np.ndarray:
    """Convert change-point indices to inclusive (start, end) shot bounds, the
    ``change_points`` layout the DSNet h5 files carry (dataset.py:96)."""
    bounds = np.concatenate([[0], np.asarray(cps, dtype=np.int64), [n_frames]])
    return np.stack([bounds[:-1], bounds[1:] - 1], axis=1)


# ---------------------------------------------------------------------------
# On-device variants (tensors; the JAX package's *_jax functions)
# ---------------------------------------------------------------------------

def calc_scatters_device(K: torch.Tensor) -> torch.Tensor:
    """:func:`calc_scatters` on a tensor, on its device and in its dtype
    (the JAX ``calc_scatters_jax``): the same expression over cumulative
    sums, so f32 differs from the f64 host path by summation-order rounding
    only."""
    n = K.shape[0]
    K1 = torch.cat([K.new_zeros(1), torch.cumsum(torch.diagonal(K), 0)])
    K2 = torch.nn.functional.pad(torch.cumsum(torch.cumsum(K, 0), 1),
                                 (1, 0, 1, 0))
    i = torch.arange(n, device=K.device)[:, None]
    j = torch.arange(n, device=K.device)[None, :]
    d2 = torch.diagonal(K2)
    diag_sum = K1[1:][None, :] - K1[:n][:, None]
    block_sum = (d2[1:][None, :] + d2[:n][:, None]
                 - K2[1:, :n].T - K2[:n, 1:])
    scatters = diag_sum - block_sum / (j - i + 1)
    return torch.where(j >= i, scatters, K.new_zeros(()))


def _cpd_dp_device(K: torch.Tensor, m: int, lmin: int, lmax: int):
    """The DP over k = 1..m on ``K``'s device (the JAX ``_cpd_scan_jax``):
    each step takes the column-wise min / first argmin of the candidate
    matrix ``I[k-1, t] + J[t, l-1]`` over the valid t. Returns (I0 (n+1,),
    rows (m, n+1), ptrs (m, n+1) int64).

    One (n, n) matrix of scatters with the k-independent bounds already
    set to inf is built once; step k reads its rows t >= k * lmin (the
    k-dependent bound) into one preallocated buffer, so memory stays at two
    (n, n) matrices whatever m. The sentinels are built in ``K``'s dtype, as
    in the JAX package: in float32 both are inf, so "improved" there means
    ``best < inf``."""
    n = K.shape[0]
    dev, dt = K.device, K.dtype
    J = calc_scatters_device(K)
    big_init = torch.tensor(_HUGE_INIT, dtype=dt, device=dev)
    big = torch.tensor(_HUGE, dtype=dt, device=dev)
    inf = torch.tensor(float("inf"), dtype=dt, device=dev)

    idx = torch.arange(n + 1, device=dev)
    fill = (idx >= lmin) & (idx < lmax) & (idx - 1 < n)
    I0 = torch.where(fill, J[0, (idx - 1).clamp(0, n - 1)], big_init)

    l_vals = torch.arange(1, n + 1, device=dev)
    t_vals = torch.arange(n, device=dev)[:, None]
    Jm = torch.where((t_vals >= l_vals[None, :] - lmax)
                     & (t_vals <= l_vals[None, :] - lmin), J, inf)
    del J
    rows = torch.empty((m, n + 1), dtype=dt, device=dev)
    ptrs = torch.zeros((m, n + 1), dtype=torch.int64, device=dev)
    cand = torch.empty((n, n), dtype=dt, device=dev)
    prev = I0
    for k in range(1, m + 1):
        t0 = k * lmin
        touched = l_vals >= (k + 1) * lmin
        if t0 >= n:   # no valid t: no column is touched either
            rows[k - 1] = prev
            prev = rows[k - 1]
            continue
        c = cand[: n - t0]
        torch.add(prev[t0:n, None], Jm[t0:], out=c)
        best, arg = torch.min(c, dim=0)   # the first minimum: earliest t
        improved = best < big
        tail = torch.where(touched, torch.where(improved, best, big),
                           prev[1:])
        rows[k - 1, :1] = prev[:1]
        rows[k - 1, 1:] = tail
        ptrs[k - 1, 1:] = torch.where(touched & improved, arg + t0, 0)
        prev = rows[k - 1]
    return I0, rows, ptrs


def _scores_from(I0: torch.Tensor, rows: torch.Tensor, n: int) -> torch.Tensor:
    scores = torch.cat([I0[n:n + 1], rows[:, n]])
    return torch.where(scores > 1e99, torch.full_like(scores, float("inf")),
                       scores)


def cpd_nonlin_device(K: torch.Tensor, ncp: int, lmin: int = 1,
                      lmax: int = 100000):
    """:func:`cpd_nonlin` on a tensor, on its device (the JAX
    ``cpd_nonlin_jax``). Returns (cps (ncp,) int64, scores (ncp+1,)) as
    tensors on ``K``'s device."""
    m = int(ncp)
    n = K.shape[0]
    I0, rows, ptrs = _cpd_dp_device(K, m, lmin, lmax)
    if m == 0:
        return torch.zeros(0, dtype=torch.int64, device=K.device), I0[n:n + 1]
    cps = torch.empty(m, dtype=torch.int64, device=K.device)
    cur = torch.tensor(n, device=K.device)
    for k in range(m - 1, -1, -1):
        cur = ptrs[k, cur]
        cps[k] = cur
    return cps, _scores_from(I0, rows, n)


def kts_segmentation_device(K: torch.Tensor, ncp: int, vmax: float,
                            desc_rate: int = 1, lmin: int = 1,
                            lmax: int = 100000):
    """The whole auto-KTS on ``K``'s device (the JAX
    ``kts_segmentation_jax``): one DP pass over k = 1..ncp keeping the
    pointer table, the change-point count picked by the penalised cost
    (``cpd_auto.py:5-47``; the first minimum), and one masked backtrack of
    that count from the table (the host path re-runs the DP for it).

    Returns ``(cps (ncp,), m_best, costs (ncp+1,))`` as tensors on ``K``'s
    device without synchronising; only ``cps[:m_best]`` is meaningful (the
    rest is 0). The arithmetic is ``K``'s dtype (f32 from the pipeline); the
    float64 host :func:`kts_segmentation` is the oracle."""
    m = int(ncp)
    n = K.shape[0]
    dev, dt = K.device, K.dtype
    I0, rows, ptrs = _cpd_dp_device(K, m, lmin, lmax)
    scores = _scores_from(I0, rows, n)

    N2 = n * desc_rate
    ncps = torch.arange(1, m + 1, dtype=dt, device=dev)
    pen = (vmax * ncps / (2.0 * N2)) * (
        torch.log(torch.tensor(float(N2), dtype=dt, device=dev) / ncps) + 1.0)
    costs = scores / float(n) + torch.cat([pen.new_zeros(1), pen])
    m_best = torch.argmin(costs)

    cps = torch.zeros(m, dtype=torch.int64, device=dev)
    cur = torch.tensor(n, device=dev)
    for k in range(m - 1, -1, -1):
        active = k < m_best
        cur = torch.where(active, ptrs[k, cur], cur)
        cps[k] = torch.where(active, cur, 0)
    return cps, m_best, costs
