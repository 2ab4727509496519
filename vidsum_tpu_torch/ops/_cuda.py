"""Build and load the port's CUDA kernels: ``nvcc`` -> shared library ->
``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own for ``sm_90a`` into
``vidsum_tpu_torch/_build/lib<name>_<digest>.so``, where the digest hashes
the sources and flags, so an edited kernel is rebuilt and a stale library is
never loaded. The build runs at the first launch of a kernel (or when
:func:`build` is called); importing this module runs nothing, so the package
imports on a machine without ``nvcc``. The libraries expose plain C functions
that take raw device pointers and PyTorch's current stream, and return the
``cudaError_t`` of their launch, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Dict, Iterable, Optional

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
KERNELS = ("gemm_bias_epilogue", "masked_attention", "block_train",
           "attention_train", "int8_gemm")
HEADERS = ("common.cuh", "attention_core.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_vp, _int, _uint, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_longlong, ctypes.c_float)
# library -> the C functions it exports, with their argument types
_SIGNATURES = {
    "gemm_bias_epilogue": {
        "vs_gemm_bias_epilogue": [_vp] * 9 + [_int] * 5 + [_f32, _vp]},
    "masked_attention": {
        "vs_masked_attention": [_vp] * 7 + [_int] * 4 + [_ll] * 9
        + [_f32, _int, _int, _int, _vp]},
    "block_train": {
        "vs_bt_gemm": [_vp] * 8 + [_int] * 3 + [_ll] * 4 + [_int] * 2
        + [_uint, _int, _int, _uint, _f32, _vp],
        "vs_bt_drop_res_ln": [_vp] * 7 + [_int] * 3
        + [_uint, _int, _uint, _f32, _f32, _vp],
        "vs_bt_ln_bwd_drop": [_vp] * 6 + [_int] * 3
        + [_uint, _int, _uint, _f32, _vp],
        "vs_bt_colsum": [_vp] * 5 + [_int] * 2 + [_vp],
        "vs_bt_attention_fwd": [_vp] * 4 + [_int] * 4
        + [_f32, _uint, _uint, _f32, _vp],
        "vs_bt_attention_bwd": [_vp] * 7 + [_int] * 4
        + [_f32, _uint, _uint, _f32, _vp]},
    "attention_train": {
        "vs_at_fwd": [_vp] * 6 + [_int] * 4
        + [_f32, _uint, _uint, _f32, _int, _int, _vp],
        "vs_at_bwd": [_vp] * 11 + [_int] * 4
        + [_f32, _uint, _uint, _f32, _int, _int, _vp]},
    "int8_gemm": {
        "vs_int8_gemm": [_vp] * 13 + [_int] * 5 + [_f32, _vp],
        "vs_quantize_rows": [_vp] * 3 + [_int] * 3 + [_vp]},
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, "
                           "/usr/local/cuda/bin and PATH); the CUDA kernels "
                           "cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (f"{name}.cu",) + HEADERS:
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}_{_digest(name)}.so")


def build(names: Iterable[str] = KERNELS, ptxas_verbose: bool = False
          ) -> Dict[str, str]:
    """Compile every named kernel that has no up-to-date library, one
    ``nvcc`` per source, all started together. Returns ``{name: compiler
    diagnostics}`` (register and shared-memory use with ``ptxas_verbose``).
    Raises ``RuntimeError`` with the compiler's output if any build fails."""
    nvcc = nvcc_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out) and not ptxas_verbose:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, f"{name}.cu")]
        if ptxas_verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        logs[name] = proc.communicate()[0]
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.unlink(tmp)
            failed.append(name)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n"
                           + "\n".join(logs[n] for n in failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = lib_path(name)
            if not os.path.exists(path):
                build([name])
            lib = ctypes.CDLL(path)
            for fn_name, argtypes in _SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vs_error_string.argtypes = [ctypes.c_int]
            lib.vs_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        msg = lib.vs_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({msg})")


def ptr(t) -> Optional[int]:
    """Device pointer of a tensor for a ``c_void_p`` argument (None -> NULL)."""
    return None if t is None else t.data_ptr()


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


DTYPE_CODES = {"float32": 0, "bfloat16": 1}


def dtype_code(t) -> int:
    name = str(t.dtype).replace("torch.", "")
    if name not in DTYPE_CODES:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, got "
                        f"{t.dtype}")
    return DTYPE_CODES[name]
