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
           "attention_train", "int8_gemm", "ring_attention", "row_norms")
HEADERS = ("common.cuh", "attention_core.cuh", "attention_train_mma.cuh",
           "mma_tiles.cuh", "fma_gemm.cuh", "tma_ring.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# The head_dims the attention kernels are instantiated for (96 is d_model
# 384 with 4 heads and 768 with 8): any other head_dim up to 128 runs
# zero-padded to the next of them, and a wider one in slices of the widest,
# SLICE_DH (see kernel_head_dim). d_model takes any width: LayerNorm rows
# past 1,024 columns, or off the 32-column grid, take the row kernels'
# looping variants (ln_rows_path), and the int8 GEMM pads K to its 32-deep
# steps. The only limit left is the card's memory.
HEAD_DIMS = (16, 32, 64, 96, 128)
SLICE_DH = HEAD_DIMS[-1]

_vp, _int, _uint, _ll, _f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_uint,
                               ctypes.c_longlong, ctypes.c_float)
# library -> the C functions it exports, with their argument types
_SIGNATURES = {
    "gemm_bias_epilogue": {
        "vs_gemm_bias_epilogue": [_vp] * 9 + [_int] * 9 + [_f32, _vp],
        "vs_gemm_wgmma_smem": [_int, _int]},
    "masked_attention": {
        "vs_masked_attention": [_vp] * 7 + [_int] * 4 + [_ll] * 9
        + [_f32, _int, _int, _int, _int, _vp],
        "vs_masked_attention_posbias": [_vp] * 7 + [_int] * 4 + [_ll] * 6
        + [_vp]},
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
        "vs_int8_gemm": [_vp] * 13 + [_int] * 7 + [_f32, _vp],
        "vs_int8_gemm_smem": [_int, _int],
        "vs_quantize_rows": [_vp] * 3 + [_int] * 3 + [_vp]},
    "ring_attention": {
        "vs_ring_fwd": [_vp] * 10 + [_int] * 7 + [_uint] + [_int] * 3
        + [_uint, _f32, _vp],
        "vs_ring_bwd": [_vp] * 14 + [_int] * 9 + [_uint] + [_int] * 3
        + [_uint, _f32, _vp],
        "vs_ring_slots": [_int] * 5 + [_vp]},
    "row_norms": {
        "vs_row_norms": [_vp] * 6 + [_int] * 3 + [_f32, _vp]},
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


def kernel_head_dim(Dh: int, what: str) -> int:
    """The head_dim the attention kernels run a head of ``Dh`` at: the
    smallest entry of ``HEAD_DIMS`` that holds it, or past the widest a
    multiple of it, ``head_slices(Dh) * SLICE_DH`` (160 -> 256, 320 ->
    384), which every kernel family runs in slices of ``SLICE_DH`` columns
    (one CTA a slice; the scores summed over all of them). The wrappers
    zero-pad q, k and v (and o and its cotangent) along head_dim to that
    width and slice the results back, which is exact: zero columns add
    nothing to Q.K^T (so the scores, the softmax and the caller's scale are
    those of the unpadded head), V's zero columns give zero output
    columns, and the padded columns of dQ, dK and dV are zero. Raises
    ``ValueError`` only for a head_dim below 1."""
    if Dh <= 0:
        raise ValueError(f"{what} take head_dim >= 1, got {Dh}")
    for dp in HEAD_DIMS:
        if Dh <= dp:
            return dp
    return head_slices(Dh) * SLICE_DH


def head_slices(Dh: int) -> int:
    """The ``SLICE_DH``-column slices the kernels run a head of ``Dh`` in:
    1 up to ``SLICE_DH``, else ceil(Dh / SLICE_DH). Each slice's CTAs
    recompute the head's scores, so the attention's products past the
    output cost this factor over the bound."""
    return max(1, -(-Dh // SLICE_DH))


def pad_head_dim(t, dp: int):
    """``t`` zero-padded along its last dim to ``dp`` columns (a new
    contiguous tensor), or ``t`` itself where it has them."""
    import torch

    if t.shape[-1] == dp:
        return t
    return torch.nn.functional.pad(t, (0, dp - t.shape[-1]))


# The GEMMs' residual+LayerNorm epilogue holds a row of up to LN_TILE
# columns in one CTA tile; wider rows go through an f32 buffer and a row
# kernel (in f32 every row; the row kernel holds 16 values a lane up to d
# 512, 24 up to 768 and 32 up to LN_ROWS_MAX; past it the row kernel's
# looping variant walks the row from device memory).
LN_TILE = 256
LN_ROWS_MAX = 1024


def ln_rows_path(N: int, f32: bool) -> str:
    """Which kernel normalises a residual+LayerNorm row of ``N`` columns
    after a serving GEMM: ``"tile"`` (bf16 and int8 rows of up to
    ``LN_TILE``, in the GEMM's CTA), ``"rows"`` (``common.cuh``'s
    ``layernorm_rows_kernel``, a row held in a warp's registers) or
    ``"wide"`` (``layernorm_rows_wide_kernel``, past ``LN_ROWS_MAX``). The
    training block's row kernels (``block_train.cu``) take ``"wide"`` also
    for d off the 32-column grid."""
    if N <= 0:
        raise ValueError(f"a LayerNorm row needs N >= 1, got {N}")
    if N > LN_ROWS_MAX:
        return "wide"
    return "rows" if f32 or N > LN_TILE else "tile"


def aligned16(t):
    """``t`` (contiguous) itself, or a copy where its data does not start on
    a 16-byte boundary: kernels that stage 16-byte chunks take it so."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


_sms: Dict[int, int] = {}


def sm_count(device) -> int:
    """The number of SMs of a CUDA device (cached)."""
    import torch

    idx = device.index if device.index is not None else \
        torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


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
