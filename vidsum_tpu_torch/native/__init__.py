# ported from vidsum_tpu/native/__init__.py
"""ctypes bindings for the C++ eval runtime (see ``src/eval_runtime.cc``).

The library is built on first use (g++ into ``vidsum_tpu_torch/_build/``)
rather than at import. Callers check :func:`available` and fall back to the
NumPy paths when the library cannot be built or loaded: the NumPy
implementations in ``vidsum_tpu_torch.ops`` are the semantics of record, the
native ones bit-identical accelerations (``tests/test_torch_eval.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import List, Optional, Tuple

import numpy as np

from vidsum_tpu_torch.native.build import build as _build
from vidsum_tpu_torch.native.build import lib_path as _lib_path

_lock = threading.Lock()
_state = {"lib": None, "error": None}


def _load() -> ctypes.CDLL:
    path = _lib_path()
    if not os.path.exists(path):
        path = _build(verbose=False)
    lib = ctypes.CDLL(path)

    i64 = ctypes.c_int64
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

    lib.vs_knapsack.restype = i64
    lib.vs_knapsack.argtypes = [i64, pi64, pf64, i64, pi64]
    lib.vs_calc_scatters.restype = None
    lib.vs_calc_scatters.argtypes = [pf64, i64, pf64]
    lib.vs_cpd_dp.restype = None
    lib.vs_cpd_dp.argtypes = [pf64, i64, i64, i64, i64, pf64, pi64]
    return lib


def _lib() -> Optional[ctypes.CDLL]:
    with _lock:
        if _state["lib"] is None and _state["error"] is None:
            try:
                _state["lib"] = _load()
            except (OSError, subprocess.SubprocessError) as e:
                _state["error"] = e
        return _state["lib"]


def available() -> bool:
    """Whether the native library is built and loaded (builds it once)."""
    return _lib() is not None


def load_error() -> Optional[BaseException]:
    """Why the library is unavailable, or None."""
    return _state["error"]


def knapsack_native(W: int, wt: np.ndarray, val: np.ndarray) -> List[int]:
    wt = np.ascontiguousarray(wt, dtype=np.int64)
    val = np.ascontiguousarray(val, dtype=np.float64)
    n = len(wt)
    out = np.zeros(max(n, 1), dtype=np.int64)
    count = _lib().vs_knapsack(int(W), wt, val, n, out)
    return out[:count].tolist()


def calc_scatters_native(K: np.ndarray) -> np.ndarray:
    K = np.ascontiguousarray(K, dtype=np.float64)
    n = K.shape[0]
    out = np.zeros((n, n), dtype=np.float64)
    _lib().vs_calc_scatters(K, n, out)
    return out


def cpd_dp_native(J: np.ndarray, m: int, lmin: int = 1,
                  lmax: int = 100000) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (cps (m,), scores (m+1,)) from a precomputed scatter matrix."""
    J = np.ascontiguousarray(J, dtype=np.float64)
    n = J.shape[0]
    scores = np.zeros(m + 1, dtype=np.float64)
    cps = np.zeros(max(m, 1), dtype=np.int64)
    _lib().vs_cpd_dp(J, n, m, lmin, lmax, scores, cps)
    return cps[:m], scores
