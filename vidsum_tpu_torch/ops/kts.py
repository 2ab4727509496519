# ported from vidsum_tpu/ops/kts.py (NumPy and native paths; the on-device
# variants arrive with the device-eval slice)
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
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

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
