#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving, finetune and long-video finetune
paths on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, each printing one JSON line (any failure exits non-zero, no phase is
caught and passed over):

1. device: the card's name and power limit (``nvidia-smi``).
2. build: every CUDA kernel of the path (``nvcc``, one process per source,
   started together) and the host C++ eval runtime (``g++``), from this
   checkout's sources; the compilers' register/shared-memory report goes to
   stderr.
3. kernels: each route of the two hand-written kernels against its plain
   PyTorch version on the card, in bf16 and f32 (TF32 off), at the shapes
   the serving path gives it: the fused block at (B, N) = (32, 512) (the
   per-element route) and (8, 256) (the grouped route), flash attention at
   N = 6,016 (single pass) and 16,384 (key-folded). Each prints its max abs
   and relative RMS error and its tolerance (for attention also the error
   of a planted fault, one key tile dropped, which must fail that
   tolerance, and in bf16 the error against the other order of rounding P,
   which must be at least twice its own), the median CUDA-event time of
   the kernel, its plain version and one library call
   (``nn.TransformerEncoderLayer`` / ``F.scaled_dot_product_attention``,
   timed as a yardstick only; the port never calls them), and the bound:
   the larger of the bytes the function must move over the card's memory
   rate and its operations over the card's peak rate for the input type.
4. train kernels: the four training routes of the fused block
   (``ops/block_train.py``, TPU kernels 9-12) at (B, N) = (32, 512)
   (per-element) and (8, 256) (grouped), dropout 0.3, f32 and bf16 inputs:
   the forward, dx and all packed parameter grads against autograd of the
   plain version with the same dropout bits, each by an elementwise and a
   relative RMS bound at f32 summation-order level (rows with an fc1 input
   within rounding of 0 get a zero cotangent, so no ReLU branch flip enters
   the grads); the kernels run at seed + 1 (a planted fault) must
   fail them, and two backward runs must give identical bits. Prints the
   median CUDA-event ms of each route, its plain version and
   ``nn.TransformerEncoderLayer(dropout=0.3)`` in train mode (forward, and
   forward + backward; timed only), the bound against the f32 peak (the
   products are f32) and the memory rate, and a ``torch.profiler``
   breakdown of the (32, 512) f32 routes by kernel.
5. train attention kernels: the four routes of ``flash_attention_dropout``
   (``ops/attention_train.py``, TPU kernels 5-8) called directly at
   (B, H, N, Dh) = (2, 4, 8192, 64), valid lengths (8100, 5000), dropout
   0.3, f32 and bf16: o, lse, dq, dk and dv against the plain versions on
   the card (the folded one over the kernel's 64-key tiles) by an
   elementwise and a relative RMS bound; the kernels at seed + 1 must fail
   them, two backward runs must give identical bits, and in bf16 each
   forward route must lie at least twice as close to its own plain version
   as to the other route's. Prints the median CUDA-event ms of each route,
   its plain version and ``F.scaled_dot_product_attention(dropout_p=0.3)``
   (forward, and forward + backward; timed only), and the bound (products
   at the input type's peak, the backward's dp and dV at the f32 peak).
6. serve: ``ScoringService`` with seeded flagship weights (d 256, 4 heads,
   4 layers, bf16) takes 13 requests: 320/480/512 frames with auto-KTS,
   1,200 frames, 6,000 frames (past the block envelope: flash) and 16,384
   frames (key-folded), the last two with given shots. Checks: every future
   resolves, summaries are binary and within budget, every route's launch
   counter moved during this phase (counters are zeroed just before it),
   and each request's served scores equal its solo ``make_eval_forward``
   scores bit for bit.
7. train: the finetune recipe (d 256, 4 heads, 4 layers, dropout 0.3, Adam
   lr 1e-3 / wd 1e-4, batch 4, f32) with seeded weights on in-memory videos
   in the DSNet schema made with numpy from ``--seed``: first one step on
   the first long batch on the card and on the CPU's plain path with the
   same dropout seeds (loss and each parameter's gradient must agree), and
   (a) the same on the ``"flash"`` route (N = 1,152: TPU kernels 5/6) with
   the same residual and MLP keep masks and attention seeds on both sides;
   then, with the counters zeroed, 10 epochs of ``_train_epoch`` over 8
   short videos (100-380 frames: grouped routes) and over 8 long ones
   (520-1,100 frames: per-element routes), 20 steps each, and ``_val_epoch``
   over 4 videos. Checks: finite losses, all four block training counters
   moved, val F in [0, 100] and finite tau/rho. Prints the CUDA-event ms per
   step (median, quartiles, range) at the recipe's shapes and at (32, 512),
   and a ``torch.profiler`` breakdown of both steps (device busy share,
   kernels by device time).
8. long train: (b) the ``"flash"`` route on one 8,100-frame video (bucket
   8,192, f32: the folded route, TPU kernels 7/8), card against CPU as in
   (a); (c) with the counters zeroed before each, 5 recipe epochs on the
   auto route over 8 videos of 7,950-9,000 frames (10 steps at batch 4),
   once in f32 (demoted to the folded route) and once in bf16 (the
   single-pass route). Checks: finite losses, each step launched its
   route's kernels once per layer, all four training attention counters
   moved and the block training counters did not (the demotion). Prints
   the step ms (median, quartiles, range) and a ``torch.profiler``
   breakdown of one long step per dtype.
9. the ``kernels`` line (12 routes, the training attention ones named
   ``attention_train.<route>``), the card's name and power limit, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Dense peaks of the card the runs measured (NVIDIA H100 SXM data sheet):
# bf16 tensor cores, f32 outside the tensor cores (the kernels' f32 path does
# exact f32 FMA), memory rate. Another card needs its own entry.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bfloat16": 989e12, "float32": 67e12,
                              "bytes": 3.35e12},
}
# Per kernel and dtype: elementwise |got - want| <= atol + rtol |want|, and
# the relative RMS error ||got - want|| / ||want|| <= rel. The attention
# outputs at these shapes are means over thousands of keys (typical size
# 0.01-0.02), so their bounds are absolute ones far below that size, rtol one
# bf16 step; a kernel that drops one 64-key tile fails them (checked below,
# every run). The bf16 block bound is the JAX tests' own
# (tests/test_block_kernel.py) on outputs of size 1.
TOL = {
    ("block", "bfloat16"): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("block", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("attention", "bfloat16"): dict(atol=2e-3, rtol=8e-3, rel=1e-2),
    ("attention", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-5),
    # training block: forward outputs are LayerNorm outputs of size 1 (the
    # block bounds); gradients are sums over up to B*N rows whose size
    # varies by parameter, so their atol is relative to the tensor's largest
    # entry. In f32 kernel and plain version differ by summation order
    # (measured relative RMS 1e-7 to 7e-7 on every tensor), and the check
    # keeps it so: rows whose fc1 input lies within NEAR_ZERO of 0 get a zero
    # cotangent (see phase_train_kernels), since there the ReLU may take the
    # other branch in the two versions and move the row's grads by a real
    # amount. The kernels run at seed + 1 are off by ~0.3. With bf16 inputs
    # the output and dx are also rounded to bf16 (one step)
    ("train_fwd", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_fwd", "bfloat16"): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("train_grad", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_dx", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("train_dx", "bfloat16"): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
    # a whole 4-layer finetune step, card against CPU, each parameter's grad
    # on its own: atol relative to the largest grad of the step, relative
    # RMS per tensor. Here no row can be spared a ReLU flip (attention mixes
    # rows between layers), and a flip in a later layer moves every grad
    # upstream of it by a relative RMS of up to ~1e-3 (measured 3e-5 to
    # 9e-4, the embed weight's the largest: its grad is a sum of rank-one
    # terms that mostly cancel). This check is for the wiring (the autograd
    # Function, the packing of Q/K/V, a grad reaching the wrong parameter:
    # errors of order 1); the kernels' precision is held by the f32 bounds
    # above. A grad whose reference norm is at rounding level (below
    # ROUNDING_NORM of the largest: the key bias's, which softmax's shift
    # invariance makes 0) is held by the elementwise bound only
    ("step_grad", "float32"): dict(atol=1e-4, rtol=1e-3, rel=2e-3),
    # training attention (TPU kernels 5-8): o at the slice-1 attention
    # bounds; lse at f32 summation-order level in both dtypes; grads with
    # atol relative to the tensor's largest entry, f32 at summation-order
    # level, bf16 one bf16 step (ds is rounded to bf16 before dq and dk, and
    # the outputs are bf16). The kernels run at seed + 1 are off by ~0.5
    ("attn_train_o", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-5),
    ("attn_train_o", "bfloat16"): dict(atol=2e-3, rtol=8e-3, rel=1e-2),
    ("attn_train_lse", "float32"): dict(atol=1e-5, rtol=1e-5, rel=1e-6),
    ("attn_train_lse", "bfloat16"): dict(atol=1e-5, rtol=1e-5, rel=1e-6),
    ("attn_train_grad", "float32"): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("attn_train_grad", "bfloat16"): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
}
# fc1 inputs nearer 0 than this share of their RMS may take the other ReLU
# branch in kernel and plain version (their difference is < 2e-5 of the RMS)
NEAR_ZERO = 2e-4
ROUNDING_NORM = 1e-6


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def peaks_for(name: str) -> dict:
    if name not in PEAKS:
        raise RuntimeError(f"no peak rates for {name!r}: add the card's "
                           f"data-sheet peaks to PEAKS")
    return PEAKS[name]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
    return statistics.median(cuda_times(fn, reps, warmup))


def cuda_times(fn, reps: int, warmup: int = 2) -> list:
    """CUDA-event times of ``reps`` runs of ``fn`` in milliseconds."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return times


def spread(times: list) -> dict:
    """Median, quartiles and range of a list of times."""
    q1, _, q3 = statistics.quantiles(times, n=4)
    return {"n": len(times), "median": statistics.median(times), "q1": q1,
            "q3": q3, "min": min(times), "max": max(times)}


def device_profile(fn, reps: int, top: int = 8) -> dict:
    """``fn`` run ``reps`` times under ``torch.profiler``: host wall ms per
    run (ending in a synchronise), device kernel ms per run, the device's
    busy share of the wall, and the ``top`` kernels by device time (ms per
    run, launches per run)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / reps
    kernels = {}
    for e in prof.events():
        # kernels only: a range annotation (Optimizer.step) spans others
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not getattr(e, "is_user_annotation", False)):
            ms, n = kernels.get(e.name, (0.0, 0))
            kernels[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    device = sum(ms for ms, _ in kernels.values()) / reps
    ranked = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall, "device_ms": device,
            "busy_share": device / wall if wall else None,
            "top": [[name[:60], ms / reps, n / reps]
                    for name, (ms, n) in ranked]}


def pad_mask(B: int, N: int, rng, device):
    """Key padding with a ragged tail per row and >= 1 real key per row."""
    import numpy as np
    import torch

    m = np.zeros((B, N), bool)
    for b in range(B):
        m[b, int(rng.integers(N // 2, N + 1)):] = True
    return torch.from_numpy(m).to(device)


def errors(got, want) -> tuple:
    """(max abs error, relative RMS error); inf if got is not finite."""
    import torch

    g, w = got.detach().float(), want.detach().float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    diff = g - w
    return (float(diff.abs().max()),
            float(diff.norm() / w.norm().clamp_min(1e-30)))


def within(got, want, tol: dict) -> bool:
    g, w = got.float(), want.float()
    _, rel = errors(got, want)
    return bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all()
                ) and rel <= tol["rel"]


def check_close(got, want, tol: dict, what: str = "") -> tuple:
    err, rel = errors(got, want)
    if not within(got, want, tol):
        raise AssertionError(f"kernel disagrees with its plain version{what}: "
                             f"max abs err {err}, relative RMS {rel} "
                             f"(tolerance {tol})")
    return err, rel


def scaled(tol: dict, want) -> dict:
    """``tol`` with its atol relative to the largest entry of ``want``."""
    return {**tol, "atol": tol["atol"] * float(want.float().abs().max())}


def phase_device() -> dict:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(smi, flush=True)
    emit("device", nvidia_smi=smi, name=name, count=torch.cuda.device_count(),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0])
    return {"smi": smi, "name": name}


def phase_build() -> None:
    from vidsum_tpu_torch import native
    from vidsum_tpu_torch.native import build as native_build
    from vidsum_tpu_torch.ops import _cuda

    t0 = time.monotonic()
    logs = _cuda.build(ptxas_verbose=True)
    t_cuda = time.monotonic() - t0
    for name, log in logs.items():
        print(f"--- nvcc {name} ---\n{log}", file=sys.stderr, flush=True)
    t1 = time.monotonic()
    native_build.build(verbose=False)
    if not native.available():
        raise RuntimeError(f"native eval runtime did not load: "
                           f"{native.load_error()}")
    emit("build", cuda_s=round(t_cuda, 3),
         native_s=round(time.monotonic() - t1, 3),
         libraries=sorted(os.path.basename(_cuda.lib_path(n))
                          for n in _cuda.KERNELS))


def library_block(block, d: int, H: int, dtype, dropout: float = 0.0):
    """nn.TransformerEncoderLayer computing the same function as the block:
    its Q weights are scaled by sqrt(head_dim / d_model), so its
    head_dim**-0.5 scale becomes the reference's d_model**-0.5. With
    ``dropout`` it is in train mode, else in eval mode."""
    import torch
    from torch import nn

    layer = nn.TransformerEncoderLayer(d, H, 4 * d, dropout=dropout,
                                       batch_first=True)
    sa = block.sa
    with torch.no_grad():
        f = (d // H / d) ** 0.5
        layer.self_attn.in_proj_weight.copy_(torch.cat(
            [sa.q.weight * f, sa.k.weight, sa.v.weight]))
        layer.self_attn.in_proj_bias.copy_(torch.cat(
            [sa.q.bias * f, sa.k.bias, sa.v.bias]))
        layer.self_attn.out_proj.weight.copy_(sa.feature_projection.weight)
        layer.self_attn.out_proj.bias.copy_(sa.feature_projection.bias)
        layer.linear1.weight.copy_(block.mlp.fc1.weight)
        layer.linear1.bias.copy_(block.mlp.fc1.bias)
        layer.linear2.weight.copy_(block.mlp.fc2.weight)
        layer.linear2.bias.copy_(block.mlp.fc2.bias)
        for dst, src in ((layer.norm1, block.norm1),
                         (layer.norm2, block.norm2)):
            dst.weight.copy_(src.weight)
            dst.bias.copy_(src.bias)
    layer = layer.to(device=block.norm1.weight.device, dtype=dtype)
    return layer.train() if dropout else layer.eval()


def phase_kernels(dev: dict, seed: int) -> dict:
    """Every route against its plain version in bf16 and f32; returns the
    bf16 numbers per route for the kernels line."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    d, H, Dh = cfg.d_model, cfg.num_heads, cfg.head_dim
    cuda = torch.device("cuda")
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed)
                   ).encoder.module_list[0]
    rng = np.random.default_rng(seed)
    out = {}

    def bound(flops, nbytes, dtype_name):
        t_ops = flops / peaks[dtype_name] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    for B, N, route in ((32, 512, "_fused_block"),
                        (8, 256, "_fused_block_grouped")):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            w = bk.block_weights(block, dtype)
            layer = library_block(block, d, H, dtype)
            counter = getattr(bk, route)
            before = counter.launches
            with torch.inference_mode():
                got = bk.fused_encoder_block(block, x, mask, H,
                                             cfg.attn_scale)
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"({B}, {N}) did not take {route}")
                want = bk.encoder_block_reference(w, x, mask, H,
                                                  cfg.attn_scale)
                tol = TOL[("block", dn)]
                err, rel = check_close(got, want, tol)
                ms = cuda_ms(lambda: bk.fused_encoder_block(
                    block, x, mask, H, cfg.attn_scale), reps=20)
                plain_ms = cuda_ms(lambda: bk.encoder_block_reference(
                    w, x, mask, H, cfg.attn_scale), reps=5)
                lib_ms = cuda_ms(lambda: layer(x, src_key_padding_mask=mask),
                                 reps=20)
            itm = x.element_size()
            flops = B * N * 24 * d * d + 4 * N * valid * d
            nbytes = (2 * B * N * d * itm + 12 * d * d * itm
                      + 13 * d * 4 + B * N)
            b_ms, b_by = bound(flops, nbytes, dn)
            emit("kernel", route=route, B=B, N=N, dtype=dn, max_abs_err=err,
                 rel_rms_err=rel, tolerance=tol, ms=ms, plain_ms=plain_ms,
                 library_ms=lib_ms, bound_ms=b_ms, bound_by=b_by,
                 flops=flops, bytes=nbytes)
            if dtype == torch.bfloat16:
                out[route] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)

    for N, route in ((6016, "_flash_attention"),
                     (16384, "_flash_attention_folded")):
        B = 1
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            q, k, v = (torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
                np.float32)).to(cuda, dtype) for _ in range(3))
            counter = getattr(at, route)
            before = counter.launches
            with torch.inference_mode():
                got = at.flash_attention(q, k, v, mask, cfg.attn_scale)
                torch.cuda.synchronize()
                if counter.launches != before + 1:
                    raise AssertionError(f"N={N} did not take {route}")
                # the plain version of each route's order of rounding: the
                # single pass rounds normalised P, the fold (over the
                # kernel's 64-key tiles) unnormalised P
                folded = route == "_flash_attention_folded"
                normalised = lambda: at.attention_reference(  # noqa: E731
                    q, k, v, mask, cfg.attn_scale)
                online = lambda: at.attention_folded_reference(  # noqa
                    q, k, v, mask, cfg.attn_scale, at.KEY_TILE)
                plain, other = (online, normalised) if folded else (
                    normalised, online)
                want = plain()
                tol = TOL[("attention", dn)]
                err, rel = check_close(got, want, tol)
                rel_other = None
                if dtype == torch.bfloat16:
                    # P is rounded where the route's TPU kernel rounds it:
                    # the other order is at least twice as far off
                    _, rel_other = errors(got, other())
                    if not rel < rel_other / 2:
                        raise AssertionError(
                            f"{route}: relative RMS {rel} against its own "
                            f"rounding order, {rel_other} against the other")
                # the tolerance is tight enough to see a planted fault: the
                # kernel run with its first (always unpadded) 64-key tile
                # masked out must fail it
                dropped = mask.clone()
                dropped[:, :at.KEY_TILE] = True
                bad = at.masked_attention(q, k, v, dropped, cfg.attn_scale,
                                          norm_first=not folded)
                fault_err, fault_rel = errors(bad, want)
                if within(bad, want, tol):
                    raise AssertionError(
                        f"{route} {dn}: a kernel that drops a key tile "
                        f"passes the tolerance {tol} (max abs err "
                        f"{fault_err}, relative RMS {fault_rel})")
                ms = cuda_ms(lambda: at.flash_attention(
                    q, k, v, mask, cfg.attn_scale), reps=10)
                plain_ms = cuda_ms(plain, reps=3, warmup=1)
                keep = ~mask[:, None, None, :]
                lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=keep, scale=cfg.attn_scale), reps=10)
            itm = q.element_size()
            flops = 4 * H * Dh * N * valid
            nbytes = 4 * B * H * N * Dh * itm + B * N
            b_ms, b_by = bound(flops, nbytes, dn)
            emit("kernel", route=route, B=B, N=N, dtype=dn, max_abs_err=err,
                 rel_rms_err=rel, rel_rms_err_other_order=rel_other,
                 tolerance=tol, dropped_tile_err=[fault_err, fault_rel],
                 ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=b_ms,
                 bound_by=b_by, flops=flops, bytes=nbytes)
            if dtype == torch.bfloat16:
                out[route] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                  bound_ms=b_ms, bound_by=b_by,
                                  library_ms=lib_ms)
    return out


def phase_train_kernels(dev: dict, seed: int) -> dict:
    """The four training routes against autograd of their plain version;
    returns the f32 numbers per route (the recipe trains in f32)."""
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import block_train as bt

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    d, H, rate, scale = cfg.d_model, cfg.num_heads, 0.3, cfg.attn_scale
    cuda = torch.device("cuda")
    block = SimNet(ModelConfig(num_layers=1), device=cuda,
                   generator=torch.Generator().manual_seed(seed + 2)
                   ).encoder.module_list[0]
    with torch.no_grad():
        w = bt.train_weights(block)
    rng = np.random.default_rng(seed + 3)
    dseed = int(rng.integers(0, 2**31 - 1))
    out = {}

    def bound(flops, nbytes):
        t_ops = flops / peaks["float32"] * 1e3
        t_bytes = nbytes / peaks["bytes"] * 1e3
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    for B, N, grouped in ((32, 512, False), (8, 256, True)):
        mask = pad_mask(B, N, rng, cuda)
        valid = int((~mask).sum())
        fwd = bt._fwd_kernel_grouped if grouped else bt._fwd_kernel
        bwd = bt._bwd_kernel_grouped if grouped else bt._bwd_kernel
        if (bt._pick_train_group(B, N) > 1) != grouped:
            raise AssertionError(f"({B}, {N}) does not route as expected")
        for dtype in (torch.bfloat16, torch.float32):
            dn = str(dtype).split(".")[1]
            x = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            do = torch.from_numpy(rng.normal(size=(B, N, d)).astype(
                np.float32)).to(cuda, dtype)
            # a zero cotangent for each row with an fc1 input near 0 (see
            # TOL): nothing of that row reaches its ReLU's derivative
            _, kept = bt._forward_chain(x, mask, dseed, w, H, scale, rate,
                                        keep=True)
            a1 = kept["a1"]
            near = (a1.abs() < NEAR_ZERO * a1.pow(2).mean().sqrt()).any(-1)
            do = do.masked_fill(near.view(B, N, 1), 0.0)
            del kept, a1
            f0, b0 = fwd.launches, bwd.launches
            got = fwd(x, mask, dseed, w, H, scale, rate)
            dx, grads = bwd(x, mask, dseed, w, do, H, scale, rate)
            torch.cuda.synchronize()
            if (fwd.launches, bwd.launches) != (f0 + 1, b0 + 1):
                raise AssertionError(f"({B}, {N}) did not launch its routes")
            want = bt.block_reference_with_masks(x, w, mask, dseed, H, scale,
                                                 rate)
            wdx, wgrads = bt.block_reference_backward(x, w, mask, dseed, do,
                                                      H, scale, rate)
            ftol = TOL[("train_fwd", dn)]
            gtol = TOL[("train_grad", "float32")]
            dxtol = TOL[("train_dx", dn)]
            fwd_err = check_close(got, want, ftol)
            dx_err = check_close(dx, wdx, scaled(dxtol, wdx), " (dx)")
            grad_err = {n: check_close(a, b, scaled(gtol, b), f" (d{n})")
                        for n, a, b in zip(bt.TrainWeights._fields, grads,
                                           wgrads)}
            # a planted fault: the kernels at seed + 1 fail the bounds
            bad = fwd(x, mask, dseed + 1, w, H, scale, rate)
            bad_dx, bad_grads = bwd(x, mask, dseed + 1, w, do, H, scale,
                                    rate)
            if (within(bad, want, ftol)
                    or within(bad_dx, wdx, scaled(dxtol, wdx))
                    or within(bad_grads.wqkv, wgrads.wqkv,
                              scaled(gtol, wgrads.wqkv))):
                raise AssertionError(f"({B}, {N}) {dn}: the kernels at seed "
                                     f"+ 1 pass the bounds")
            fault = (errors(bad, want)[1], errors(bad_dx, wdx)[1])
            dx2, grads2 = bwd(x, mask, dseed, w, do, H, scale, rate)
            if not (torch.equal(dx, dx2) and all(
                    torch.equal(a, b) for a, b in zip(grads, grads2))):
                raise AssertionError(f"({B}, {N}) {dn}: two backward runs "
                                     f"differ")
            ms_f = cuda_ms(lambda: fwd(x, mask, dseed, w, H, scale, rate),
                           reps=10)
            ms_b = cuda_ms(lambda: bwd(x, mask, dseed, w, do, H, scale,
                                       rate), reps=10)
            plain_f = cuda_ms(lambda: bt.block_reference_with_masks(
                x, w, mask, dseed, H, scale, rate), reps=3, warmup=1)
            plain_b = cuda_ms(lambda: bt.block_reference_backward(
                x, w, mask, dseed, do, H, scale, rate), reps=3, warmup=1)
            layer = library_block(block, d, H, dtype, dropout=rate)
            xl = x.detach().requires_grad_()

            def lib_fwd_bwd():
                layer(xl, src_key_padding_mask=mask).backward(do)

            with torch.no_grad():
                lib_f = cuda_ms(lambda: layer(x, src_key_padding_mask=mask),
                                reps=10)
            lib_b = cuda_ms(lib_fwd_bwd, reps=10)
            prof = None
            if dtype == torch.float32 and not grouped:
                prof = {"fwd": device_profile(lambda: fwd(
                    x, mask, dseed, w, H, scale, rate), reps=3),
                        "bwd": device_profile(lambda: bwd(
                            x, mask, dseed, w, do, H, scale, rate), reps=3)}
            itm = x.element_size()
            w_bytes = 12 * d * d * 4 + 13 * d * 4
            flops_f = 24 * B * N * d * d + 4 * d * N * valid
            bytes_f = 2 * B * N * d * itm + w_bytes + B * N
            flops_b = 48 * B * N * d * d + 8 * d * N * valid
            bytes_b = 3 * B * N * d * itm + 2 * w_bytes + B * N
            bf_ms, bf_by = bound(flops_f, bytes_f)
            bb_ms, bb_by = bound(flops_b, bytes_b)
            name_f = fwd.__name__
            name_b = bwd.__name__
            worst = max(grad_err, key=lambda n: grad_err[n][1])
            emit("train_kernel", route=name_f, B=B, N=N, dtype=dn,
                 max_abs_err=fwd_err[0], rel_rms_err=fwd_err[1],
                 tolerance=ftol, seed_plus_one_rel_rms=fault[0], ms=ms_f,
                 plain_ms=plain_f, library_ms=lib_f, bound_ms=bf_ms,
                 bound_by=bf_by, flops=flops_f, bytes=bytes_f)
            emit("train_kernel", route=name_b, B=B, N=N, dtype=dn,
                 dx_err=dx_err, rows_zero_cotangent=int(near.sum()),
                 worst_grad=[worst, *grad_err[worst]],
                 grad_rel_rms={n: e[1] for n, e in grad_err.items()},
                 tolerance_dx=dxtol, tolerance_grad=gtol,
                 seed_plus_one_dx_rel_rms=fault[1], deterministic=True,
                 ms=ms_b, plain_ms=plain_b, library_ms=lib_b,
                 bound_ms=bb_ms, bound_by=bb_by, flops=flops_b,
                 bytes=bytes_b, profile=prof)
            if dtype == torch.float32:
                out[name_f] = dict(max_abs_err=fwd_err[0], ms=ms_f,
                                   plain_ms=plain_f, bound_ms=bf_ms,
                                   bound_by=bf_by, library_ms=lib_f)
                out[name_b] = dict(max_abs_err=max(
                    [dx_err[0]] + [e[0] for e in grad_err.values()]),
                    ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms,
                    bound_by=bb_by, library_ms=lib_b)
    return out


def compare_steps(results, what: str) -> dict:
    """A training forward + backward on the card against the CPU's plain
    path: the loss within 1e-4 relative and each parameter's grad by the
    step bound (a grad whose reference norm is at rounding level by the
    elementwise bound only). ``results`` is [(loss, grads)] for card, CPU."""
    (loss_card, g_card), (loss_cpu, g_cpu) = results
    if not abs(loss_card - loss_cpu) <= 1e-4 * abs(loss_cpu):
        raise AssertionError(f"{what}: loss on the card {loss_card} != CPU "
                             f"{loss_cpu}")
    gtol = TOL[("step_grad", "float32")]
    gmax = max(float(g.abs().max()) for g in g_cpu.values())
    nmax = max(float(g.norm()) for g in g_cpu.values())
    per_tensor, rounding_level = {}, []
    for k, want in g_cpu.items():
        tol = {**gtol, "atol": gtol["atol"] * gmax}
        if float(want.norm()) < ROUNDING_NORM * nmax:
            rounding_level.append(k)
            tol["rel"] = float("inf")
        per_tensor[k] = check_close(g_card[k], want, tol, f" ({what}: d {k})")
    return dict(loss=[loss_card, loss_cpu],
                grads=[max(e[0] for e in per_tensor.values()),
                       max(e[1] for k, e in per_tensor.items()
                           if k not in rounding_level)],
                largest_grad=gmax, tolerance=gtol,
                grad_rel_rms={k: e[1] for k, e in per_tensor.items()},
                rounding_level=rounding_level)


def flash_card_vs_cpu(model, cfg, xb, tb, mb, rng, what: str,
                      routes) -> dict:
    """The flash training route's forward, masked-MSE loss and backward on
    the card and on the CPU, with the same numpy-made residual and MLP keep
    masks (``dropout_masks``) and per-layer attention seeds
    (``block_seeds``): the card draws other dropout bits than the CPU from
    a generator, and ``make_finetune_step`` takes no masks. ``routes`` are
    the training attention routes the card's run must launch."""
    import copy

    import torch

    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops.losses import mse_with_mask_loss

    B, N = mb.shape
    d, L, keep = cfg.d_model, cfg.num_layers, 1.0 - cfg.dropout
    masks = [{"res1": rng.random((B, N, d)) < keep,
              "mlp": rng.random((B, N, cfg.mlp_scale * d)) < keep,
              "res2": rng.random((B, N, d)) < keep} for _ in range(L)]
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, L)]
    results, t_s = [], {}
    for dev in ("cuda", "cpu"):
        before = [getattr(at, r).launches for r in routes]
        t0 = time.monotonic()
        m = copy.deepcopy(model).to(dev)
        x, t, mk = (torch.as_tensor(a).to(dev) for a in (xb, tb, mb))
        scores, _ = m(x, mk, attn_impl="flash", deterministic=False,
                      dropout_masks=masks, block_seeds=seeds)
        loss = mse_with_mask_loss(scores, t, mk)
        loss.backward()
        results.append((float(loss.detach()),
                        {k: p.grad.detach().float().cpu()
                         for k, p in m.named_parameters()}))
        t_s[dev] = time.monotonic() - t0
        moved = [getattr(at, r).launches - b for r, b in zip(routes, before)]
        if dev == "cuda" and moved != [L] * len(routes):
            raise AssertionError(f"{what}: launches {moved} of {routes}, "
                                 f"expected {L} each")
    return dict(B=B, N=N, layers=L, routes=[attn_train_name(r)
                                            for r in routes],
                wall_s=t_s, **compare_steps(results, what))


ATTN_TRAIN_ROUTES = ("_fwd_kernel", "_bwd_kernel", "_fwd_kernel_folded",
                     "_bwd_kernel_folded")


def attn_train_name(route: str) -> str:
    """The counter and kernels-line name of a training attention route,
    qualified by its module (``block_train`` has routes of the same names)."""
    return f"attention_train.{route}"


def phase_train_attention(dev: dict, seed: int) -> dict:
    """The four training attention routes (``ops/attention_train.py``, TPU
    kernels 5-8) against their plain versions at (B, H, N, Dh) =
    (2, 4, 8192, 64), valid lengths (8100, 5000), dropout 0.3, f32 and bf16;
    returns the f32 numbers per route (the recipe trains in f32)."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.ops import attention_train as at

    peaks = peaks_for(dev["name"])
    cfg = ModelConfig()
    B, H, N, Dh = 2, cfg.num_heads, 8192, cfg.head_dim
    rate, scale = 0.3, cfg.attn_scale
    cuda = torch.device("cuda")
    rng = np.random.default_rng(seed + 5)
    dseed = int(rng.integers(0, 2**31 - 2))
    valid = (8100, 5000)
    mask = torch.ones((B, N), dtype=torch.bool, device=cuda)
    for b, n in enumerate(valid):
        mask[b, :n] = False
    keep_sdpa = ~mask[:, None, None, :]
    kb = at._pick_key_block(N)
    # the plain versions run 1,024 query rows at a time (the single pass)
    # or all rows over the kernel's 64-key tiles (the fold: in bf16 the
    # unnormalised e is rounded per tile)
    plain = {
        False: (lambda q, k, v, s: at.attention_train_fwd_reference(
                    q, k, v, mask, s, rate, scale, rows=1024),
                lambda q, k, v, s, lse, do, o: at.attention_train_bwd_reference(
                    q, k, v, mask, s, lse, do, rate, scale, rows=1024)),
        True: (lambda q, k, v, s: at.attention_train_fwd_folded_reference(
                   q, k, v, mask, s, rate, scale, at.KEY_TILE, rows=N),
               lambda q, k, v, s, lse, do, o: (
                   at.attention_train_bwd_folded_reference(
                       q, k, v, mask, s, lse, do, o, rate, scale,
                       at.KEY_TILE, rows=N))),
    }
    sum_valid = sum(valid)
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        dn = str(dtype).split(".")[1]
        itm = torch.finfo(dtype).bits // 8
        q, k, v, do = (torch.from_numpy(rng.normal(size=(B, H, N, Dh)).astype(
            np.float32)).to(cuda, dtype) for _ in range(4))
        own = {}
        for folded in (False, True):
            fwd = at._fwd_kernel_folded if folded else at._fwd_kernel
            bwd = at._bwd_kernel_folded if folded else at._bwd_kernel
            run_f = ((lambda s: fwd(q, k, v, mask, s, rate, scale, kb))
                     if folded else
                     (lambda s: fwd(q, k, v, mask, s, rate, scale)))

            def run_b(s, lse, o, bwd=bwd, folded=folded):
                if folded:
                    return bwd(q, k, v, mask, s, lse, do, o, rate, scale, kb)
                return bwd(q, k, v, mask, s, lse, do, rate, scale)

            pf, pb = plain[folded]
            f0, b0 = fwd.launches, bwd.launches
            o, lse = run_f(dseed)
            want_o, want_lse = pf(q, k, v, dseed)
            # both backward versions take the plain forward's lse and o
            grads = run_b(dseed, want_lse, want_o)
            torch.cuda.synchronize()
            if (fwd.launches, bwd.launches) != (f0 + 1, b0 + 1):
                raise AssertionError(f"{fwd.__name__} did not launch")
            want = pb(q, k, v, dseed, want_lse, do, want_o)
            otol = TOL[("attn_train_o", dn)]
            ltol = TOL[("attn_train_lse", dn)]
            gtol = TOL[("attn_train_grad", dn)]
            o_err = check_close(o, want_o, otol, " (o)")
            lse_err = check_close(lse, want_lse, ltol, " (lse)")
            grad_err = {n: check_close(a, b, scaled(gtol, b), f" (d{n})")
                        for n, a, b in zip("qkv", grads, want)}
            own[folded] = (o, want_o)
            # a planted fault: the kernels at seed + 1 fail the bounds
            bad_o, _ = run_f(dseed + 1)
            bad = run_b(dseed + 1, want_lse, want_o)
            if within(bad_o, want_o, otol) or any(
                    within(a, b, scaled(gtol, b)) for a, b in zip(bad, want)):
                raise AssertionError(f"{fwd.__name__} {dn}: the kernels at "
                                     f"seed + 1 pass the bounds")
            fault = (errors(bad_o, want_o)[1], errors(bad[0], want[0])[1])
            again = run_b(dseed, want_lse, want_o)
            if not all(torch.equal(a, b) for a, b in zip(grads, again)):
                raise AssertionError(f"{bwd.__name__} {dn}: two backward runs "
                                     f"differ")
            del bad, again
            ms_f = cuda_ms(lambda: run_f(dseed), reps=10)
            ms_b = cuda_ms(lambda: run_b(dseed, want_lse, want_o), reps=10)
            plain_f = cuda_ms(lambda: pf(q, k, v, dseed), reps=3, warmup=1)
            plain_b = cuda_ms(lambda: pb(q, k, v, dseed, want_lse, do,
                                         want_o), reps=3, warmup=1)
            # library yardstick: SDPA with its own dropout, timed only
            lib_f = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=keep_sdpa, dropout_p=rate, scale=scale),
                reps=10)
            ql, kl, vl = (t.detach().requires_grad_() for t in (q, k, v))
            lib_b = cuda_ms(lambda: F.scaled_dot_product_attention(
                ql, kl, vl, attn_mask=keep_sdpa, dropout_p=rate,
                scale=scale).backward(do), reps=10)
            del ql, kl, vl
            # bounds: the forward's two products at the input type's peak;
            # the backward's dp and dV are f32 x f32, dQ and dK at the
            # input type's peak (the recompute not counted)
            flops = 4 * H * Dh * N * sum_valid
            t_f = flops / peaks[dn]
            t_b = flops / peaks["float32"] + flops / peaks[dn]
            qkv_bytes = B * H * N * Dh * itm
            bytes_f = 4 * qkv_bytes + B * N + B * H * N * 4
            bytes_b = ((7 + int(folded)) * qkv_bytes + B * N + B * H * N * 4)
            bf_ms = max(t_f, bytes_f / peaks["bytes"]) * 1e3
            bb_ms = max(t_b, bytes_b / peaks["bytes"]) * 1e3
            bf_by = "operations" if t_f >= bytes_f / peaks["bytes"] \
                else "bytes"
            bb_by = "operations" if t_b >= bytes_b / peaks["bytes"] \
                else "bytes"
            name_f, name_b = (attn_train_name(fwd.__name__),
                              attn_train_name(bwd.__name__))
            emit("train_attention_kernel", route=name_f, B=B, H=H, N=N,
                 Dh=Dh, valid=list(valid), dtype=dn, o_err=o_err,
                 lse_err=lse_err, tolerance=otol,
                 seed_plus_one_rel_rms=fault[0], ms=ms_f, plain_ms=plain_f,
                 library_ms=lib_f, bound_ms=bf_ms, bound_by=bf_by,
                 flops=flops, bytes=bytes_f)
            emit("train_attention_kernel", route=name_b, B=B, H=H, N=N,
                 Dh=Dh, valid=list(valid), dtype=dn,
                 grad_err={n: list(e) for n, e in grad_err.items()},
                 tolerance=gtol, seed_plus_one_dq_rel_rms=fault[1],
                 deterministic=True, ms=ms_b, plain_ms=plain_b,
                 library_ms=lib_b, bound_ms=bb_ms, bound_by=bb_by,
                 flops=2 * flops, bytes=bytes_b)
            if dtype == torch.float32:
                out[name_f] = dict(max_abs_err=max(o_err[0], lse_err[0]),
                                   ms=ms_f, plain_ms=plain_f, bound_ms=bf_ms,
                                   bound_by=bf_by, library_ms=lib_f)
                out[name_b] = dict(
                    max_abs_err=max(e[0] for e in grad_err.values()),
                    ms=ms_b, plain_ms=plain_b, bound_ms=bb_ms,
                    bound_by=bb_by, library_ms=lib_b)
        if dtype == torch.bfloat16:
            # each bf16 forward route rounds where its TPU kernel does: it
            # lies at least twice as close to its own plain version as to
            # the other route's
            for folded in (False, True):
                got, mine = own[folded]
                _, other = own[not folded]
                r_own, r_other = errors(got, mine)[1], errors(got, other)[1]
                if not r_own < r_other / 2:
                    raise AssertionError(
                        f"bf16 forward (folded={folded}): relative RMS "
                        f"{r_own} against its own plain version, {r_other} "
                        f"against the other route's")
                emit("train_attention_rounding", folded=folded,
                     rel_rms_own=r_own, rel_rms_other_route=r_other)
        del q, k, v, do, own
        torch.cuda.empty_cache()
    return out


def synthetic_videos(rng, lengths, in_features: int) -> list:
    """In-memory items in the schema of ``vidsum_tpu/data/synthetic.py``:
    (features, gtscore, UserSummaries), gtscore a linear probe of the
    features through a sigmoid, 15 frames per pick, 4-8 shots, 5 users."""
    import numpy as np

    from vidsum_tpu_torch.data.datasets import UserSummaries

    probe = (rng.normal(size=(in_features,)) / np.sqrt(in_features)
             ).astype(np.float32)
    items = []
    for vi, n in enumerate(lengths):
        picks = np.arange(n) * 15
        n_frames = int(picks[-1] + rng.integers(1, 16))
        feats = rng.normal(size=(n, in_features)).astype(np.float32)
        gt = (1 / (1 + np.exp(-(feats @ probe)))).astype(np.float32)
        n_shots = int(rng.integers(4, 9))
        cuts = np.sort(rng.choice(np.arange(1, n_frames), size=n_shots - 1,
                                  replace=False))
        bounds = np.concatenate([[0], cuts, [n_frames]])
        cps = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        frame = np.repeat(gt, 15)[:n_frames]
        user_scores = np.clip(frame[None] + 0.1 * rng.normal(
            size=(5, n_frames)), 0, None).astype(np.float32)
        base = (frame >= np.quantile(frame, 0.85)).astype(np.int8)
        user_summary = np.stack([base ^ (rng.random(n_frames) < 0.05)
                                 .astype(np.int8) for _ in range(5)])
        items.append((feats, gt, UserSummaries(
            user_summary=user_summary, user_scores=user_scores,
            change_points=cps, n_frames=n_frames, picks=picks,
            name=f"video_{vi}")))
    return items


TRAIN_ROUTES = ("_fwd_kernel", "_bwd_kernel", "_fwd_kernel_grouped",
                "_bwd_kernel_grouped")
# recipe epochs over each of the short and long sets: 2 steps each, so the
# step times are medians of 20
TRAIN_EPOCHS = 10


def phase_train(seed: int) -> dict:
    import copy
    import math

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.data.collate import make_batches, pad_batch
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import (
        make_eval_forward, make_finetune_step, make_optimizer,
    )

    conf = finetune_recipe()
    cfg, tc = conf.model, conf.train
    rng = np.random.default_rng(seed + 4)
    short = synthetic_videos(rng, rng.integers(100, 381, 8), cfg.in_features)
    long_ = synthetic_videos(rng, rng.integers(520, 1101, 8),
                             cfg.in_features)
    val = synthetic_videos(rng, rng.integers(100, 1101, 4), cfg.in_features)
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed))
    step = make_finetune_step(cfg, tc.attn_impl)
    if step.attn_impl != "fused_block":
        raise AssertionError(f"the recipe trains on {step.attn_impl!r}")

    # one step on the first long batch, on the card and on the CPU's plain
    # path with the same per-layer dropout seeds
    first = next(make_batches(len(long_), tc.batch_size, shuffle=True,
                              rng=np.random.default_rng((tc.seed, 0, 1))))
    xb, tb, mb = pad_batch([long_[i][0] for i in first],
                           [long_[i][1] for i in first])
    seeds = [int(s) for s in rng.integers(0, 2**31 - 1, cfg.num_layers)]
    results = []
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev)
        loss = make_finetune_step(cfg, "fused_block", device=dev)(
            m, make_optimizer(m, tc.lr, tc.weight_decay), xb, tb, mb, None,
            block_seeds=seeds)
        results.append((float(loss), {k: p.grad.detach().float().cpu()
                                      for k, p in m.named_parameters()}))
    card_vs_cpu = compare_steps(results, "fused_block step")
    # (a) the flash route on the same batch (N = 1,152: the single-pass
    # training attention, TPU kernels 5/6), card against CPU
    flash_vs_cpu = flash_card_vs_cpu(model, cfg, xb, tb, mb, rng, "flash "
                                     "route, first long batch",
                                     ("_fwd_kernel", "_bwd_kernel"))

    optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
    times = {"short": [], "long": []}
    losses = []
    epoch_losses = {"short": [], "long": []}

    def timed(kind):
        def run(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*args)
            end.record()
            times[kind].append((start, end))
            losses.append(loss)
            return loss
        return run

    fwd = make_eval_forward(cfg)
    reset_counters()
    t0 = time.monotonic()
    # epoch e trains on the short set with the streams of (split 0, epoch
    # 2e), then on the long set with those of (0, 2e + 1): 2 steps each
    for epoch in range(TRAIN_EPOCHS):
        for i, (kind, items) in enumerate((("short", short),
                                           ("long", long_))):
            rng_np, gen = ft.epoch_streams(tc.seed, 0, 2 * epoch + i)
            epoch_losses[kind].append(ft._train_epoch(
                timed(kind), model, optimizer, items, conf, rng_np, gen))
    val_loss, f, tau, rho = ft._val_epoch(fwd, model, val, conf)
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = read_counters()
    missing = [r for r in TRAIN_ROUTES if counts[r] == 0]
    if missing:
        raise AssertionError(f"training routes never launched: {missing} "
                             f"(counters {counts})")
    step_losses = [float(x) for x in losses]
    if not all(math.isfinite(v) for v in step_losses + [val_loss]):
        raise AssertionError(f"non-finite losses: {step_losses}, {val_loss}")
    if not (0.0 <= f <= 100.0 and math.isfinite(tau)
            and math.isfinite(rho)):
        raise AssertionError(f"val metrics F {f}, tau {tau}, rho {rho}")
    step_ms = {k: spread([s.elapsed_time(e) for s, e in v])
               for k, v in times.items()}

    # a step at the flagship batch shape (32, 512), and profiles of it and
    # of a step on the first long batch
    x32 = rng.normal(size=(32, 512, cfg.in_features)).astype(np.float32)
    t32 = rng.random((32, 512)).astype(np.float32)
    m32 = np.zeros((32, 512), bool)
    xt, tt, mt = (torch.from_numpy(a).cuda() for a in (x32, t32, m32))
    step_ms["flagship_32x512"] = spread(cuda_times(
        lambda: step(model, optimizer, xt, tt, mt, gen), reps=20))
    xl, tl, ml = (torch.from_numpy(a).cuda() for a in (xb, tb, mb))
    step_profile = {
        "recipe_long_batch": device_profile(
            lambda: step(model, optimizer, xl, tl, ml, gen), reps=3),
        "flagship_32x512": device_profile(
            lambda: step(model, optimizer, xt, tt, mt, gen), reps=3)}
    emit("train", lengths_short=[int(it[0].shape[0]) for it in short],
         lengths_long=[int(it[0].shape[0]) for it in long_],
         card_vs_cpu=card_vs_cpu, flash_card_vs_cpu=flash_vs_cpu,
         epoch_loss_short=epoch_losses["short"],
         epoch_loss_long=epoch_losses["long"],
         step_losses=step_losses, val_loss=val_loss, fscore=f,
         kendall_tau=tau, spearman_rho=rho, wall_s=wall, step_ms=step_ms,
         step_profile=step_profile,
         launches=counts,
         launches_per_step={r: counts[r] / len(step_losses)
                            for r in TRAIN_ROUTES})
    return counts


# recipe epochs over the long-video set per dtype: 8 videos at batch 4, 2
# steps each, so the step times are medians of 10
LONG_EPOCHS = 5


def phase_long_train(seed: int) -> dict:
    """Finetuning on videos past the block-train envelope (N > 7,936 at
    d 256): (b) the flash route on one 8,100-frame video (bucket 8,192; f32
    takes the folded route, TPU kernels 7/8), card against CPU; (c) recipe
    epochs on the auto route over 8 videos of 7,950-9,000 frames, in f32
    (demoted to the folded route) and bf16 (the single-pass route, kernels
    5/6). Returns the training attention routes' launches in (c)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from vidsum_tpu_torch.config import finetune_recipe
    from vidsum_tpu_torch.data.collate import pad_batch
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.train import finetune as ft
    from vidsum_tpu_torch.train.steps import (
        make_finetune_step, make_optimizer,
    )

    conf = finetune_recipe()
    cfg, tc = conf.model, conf.train
    rng = np.random.default_rng(seed + 6)
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed + 1))

    # (b)
    [item] = synthetic_videos(rng, [8100], cfg.in_features)
    xb, tb, mb = pad_batch([item[0]], [item[1]])
    if xb.shape[1] != 8192 or at._single_pass_ok(8192, cfg.head_dim, 4):
        raise AssertionError(f"an 8,100-frame video buckets to "
                             f"{xb.shape[1]} frames")
    folded_vs_cpu = flash_card_vs_cpu(
        model, cfg, xb, tb, mb, rng, "flash route, one 8,100-frame video",
        ("_fwd_kernel_folded", "_bwd_kernel_folded"))
    del model

    # (c)
    videos = synthetic_videos(rng, rng.integers(7950, 9001, 8),
                              cfg.in_features)
    block_routes = TRAIN_ROUTES
    report, launches = {}, {}
    for dtype, routes in (("float32", ("_fwd_kernel_folded",
                                       "_bwd_kernel_folded")),
                          ("bfloat16", ("_fwd_kernel", "_bwd_kernel"))):
        dcfg = dataclasses.replace(cfg, compute_dtype=dtype)
        dconf = dataclasses.replace(conf, model=dcfg)
        model = SimNet(dcfg, generator=torch.Generator().manual_seed(seed))
        step = make_finetune_step(dcfg, tc.attn_impl)
        optimizer = make_optimizer(model, tc.lr, tc.weight_decay)
        times, losses, shapes = [], [], []

        def timed(*args):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss = step(*args)
            end.record()
            times.append((start, end))
            losses.append(loss)
            shapes.append(tuple(args[2].shape[:2]))
            return loss

        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        epoch_losses = [ft._train_epoch(timed, model, optimizer, videos,
                                        dconf, *ft.epoch_streams(tc.seed, 1,
                                                                 epoch))
                        for epoch in range(LONG_EPOCHS)]
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        counts = read_counters()
        names = [attn_train_name(r) for r in routes]
        n_steps = len(losses)
        if [counts[n] for n in names] != [cfg.num_layers * n_steps] * 2:
            raise AssertionError(f"{dtype} long-video epochs: launches "
                                 f"{counts}, expected {cfg.num_layers} of "
                                 f"{names} per step")
        moved = [r for r in block_routes if counts[r]]
        if moved:
            raise AssertionError(f"{dtype} long-video epochs launched the "
                                 f"block-train routes {moved}: no demotion")
        step_losses = [float(x) for x in losses]
        if not all(math.isfinite(v) for v in step_losses):
            raise AssertionError(f"non-finite losses: {step_losses}")
        for n in names:
            launches[n] = counts[n]
        xl, tl, ml = (torch.from_numpy(a).cuda() for a in pad_batch(
            [it[0] for it in videos[:tc.batch_size]],
            [it[1] for it in videos[:tc.batch_size]]))
        gen = torch.Generator().manual_seed(seed)
        report[dtype] = dict(
            routes=names, steps=n_steps, batch_shapes=shapes,
            step_ms=spread([s.elapsed_time(e) for s, e in times]),
            wall_s=wall, peak_memory_gib=peak_gb, epoch_loss=epoch_losses,
            step_losses=step_losses,
            launches={n: counts[n] for n in names},
            block_train_launches={r: counts[r] for r in block_routes},
            step_profile=device_profile(
                lambda: step(model, optimizer, xl, tl, ml, gen), reps=2))
        del model, optimizer
        torch.cuda.empty_cache()
    missing = [n for n in map(attn_train_name, ATTN_TRAIN_ROUTES)
               if not launches.get(n)]
    if missing:
        raise AssertionError(f"training attention routes never launched: "
                             f"{missing}")
    emit("long_train", lengths=[int(it[0].shape[0]) for it in videos],
         flash_folded_card_vs_cpu=folded_vs_cpu, **report)
    return launches


def reset_counters() -> None:
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_train as bt

    for fn in (bk._fused_block, bk._fused_block_grouped, at._flash_attention,
               at._flash_attention_folded, bk.gemm_bias_epilogue,
               at.masked_attention, *(getattr(bt, r) for r in TRAIN_ROUTES),
               *(getattr(att, r) for r in ATTN_TRAIN_ROUTES)):
        fn.launches = 0


def read_counters() -> dict:
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import attention_train as att
    from vidsum_tpu_torch.ops import block_kernel as bk
    from vidsum_tpu_torch.ops import block_train as bt

    return {"_fused_block": bk._fused_block.launches,
            "_fused_block_grouped": bk._fused_block_grouped.launches,
            "_flash_attention": at._flash_attention.launches,
            "_flash_attention_folded": at._flash_attention_folded.launches,
            "gemm_bias_epilogue": bk.gemm_bias_epilogue.launches,
            "masked_attention": at.masked_attention.launches,
            **{r: getattr(bt, r).launches for r in TRAIN_ROUTES},
            **{attn_train_name(r): getattr(att, r).launches
               for r in ATTN_TRAIN_ROUTES}}


def phase_serve(seed: int) -> dict:
    import numpy as np
    import torch

    from vidsum_tpu_torch.config import ModelConfig
    from vidsum_tpu_torch.data.collate import bucket_length
    from vidsum_tpu_torch.models.simnet import SimNet
    from vidsum_tpu_torch.ops import knapsack as kn
    from vidsum_tpu_torch.ops.summary import generate_summary
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.train.steps import make_eval_forward

    cfg = ModelConfig(compute_dtype="bfloat16")
    model = SimNet(cfg, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    lengths = [320, 320, 320, 320, 480, 480, 480, 512, 512, 512, 1200,
               6000, 16384]
    videos = [rng.random((n, cfg.in_features), dtype=np.float32)
              for n in lengths]

    def shots(n):   # given shot bounds for the long requests: 60-frame shots
        starts = np.arange(0, n, 60, dtype=np.int64)
        return np.stack([starts, np.minimum(starts + 59, n - 1)], axis=1)

    with ScoringService(model, cfg, max_batch=8,
                        max_delay_ms=50.0) as svc:
        reset_counters()
        t0 = time.monotonic()
        futs = [svc.submit(v, change_points=(shots(v.shape[0])
                                             if v.shape[0] >= 6000 else None))
                for v in videos]
        results = [f.result(timeout=600) for f in futs]
        wall = time.monotonic() - t0
        counts = read_counters()
        st = svc.stats()
    routes = ("_fused_block", "_fused_block_grouped", "_flash_attention",
              "_flash_attention_folded")
    missing = [r for r in routes if counts[r] == 0]
    if missing:
        raise AssertionError(f"routes never launched while serving: "
                             f"{missing} (counters {counts})")
    if st.completed != len(videos) or st.failed:
        raise AssertionError(f"serving stats: {st}")

    fwd = make_eval_forward(cfg)
    for v, r in zip(videos, results):
        n = v.shape[0]
        if r.scores.shape != (n,) or not np.all(
                (r.scores > 0) & (r.scores < 1)):
            raise AssertionError(f"bad scores for a {n}-frame request")
        s = r.summary
        budget = int(r.n_frames * 0.15)
        if s is None or s.shape != (r.n_frames,) or not set(
                np.unique(s)) <= {0, 1} or int(s.sum()) > budget:
            raise AssertionError(f"bad summary for a {n}-frame request")
        nb = bucket_length(n)
        x = np.full((1, nb, cfg.in_features), 1000.0, np.float32)
        x[0, :n] = v
        mask = np.ones((1, nb), bool)
        mask[0, :n] = False
        solo = fwd(model, x, mask)[0, :n].float().cpu().numpy()
        if not np.array_equal(solo, r.scores):
            raise AssertionError(
                f"served != solo for a {n}-frame request (max diff "
                f"{float(np.abs(solo - r.scores).max())})")
    # the native and NumPy knapsacks pick the same shots for the 1,200-frame
    # request
    r = results[10]
    native_pick = r.summary
    kn._knapsack_native, saved = None, kn._knapsack_native
    try:
        [numpy_pick] = generate_summary([r.change_points], [r.scores],
                                        [r.n_frames], [np.arange(1200)])
    finally:
        kn._knapsack_native = saved
    if not np.array_equal(native_pick, numpy_pick):
        raise AssertionError("native and NumPy knapsack disagree")

    emit("serve", requests=len(videos), lengths=lengths, wall_s=wall,
         latency_s=[round(r.latency_s, 6) for r in results],
         latency_p50_s=st.latency_p50_s, latency_p95_s=st.latency_p95_s,
         batches=st.batches, batch_hist=st.batch_hist,
         frames_per_s=sum(lengths) / wall, launches=counts,
         served_equals_solo=True)
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "vidsum_tpu_torch")):
        print("chip_smoke.py: the vidsum_tpu_torch package is not beside "
              "this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    dev = phase_device()
    phase_build()
    timings = phase_kernels(dev, args.seed)
    timings.update(phase_train_kernels(dev, args.seed))
    timings.update(phase_train_attention(dev, args.seed))
    counts = phase_serve(args.seed)
    counts.update({r: n for r, n in phase_train(args.seed).items()
                   if r in TRAIN_ROUTES})
    counts.update(phase_long_train(args.seed))

    replaces = {
        "_fused_block": "vidsum_tpu/ops/block_kernel.py:39",
        "_fused_block_grouped": "vidsum_tpu/ops/block_kernel.py:98",
        "_flash_attention": "vidsum_tpu/ops/attention.py:40",
        "_flash_attention_folded": "vidsum_tpu/ops/attention.py:76",
        "_fwd_kernel": "vidsum_tpu/ops/block_train.py:198",
        "_bwd_kernel": "vidsum_tpu/ops/block_train.py:221",
        "_fwd_kernel_grouped": "vidsum_tpu/ops/block_train.py:410",
        "_bwd_kernel_grouped": "vidsum_tpu/ops/block_train.py:421",
        **{attn_train_name(r): f"vidsum_tpu/ops/attention_train.py:{line}"
           for r, line in zip(ATTN_TRAIN_ROUTES, (83, 112, 175, 228))},
    }
    block_src = ["vidsum_tpu_torch/csrc/gemm_bias_epilogue.cu",
                 "vidsum_tpu_torch/csrc/masked_attention.cu"]
    attn_src = ["vidsum_tpu_torch/csrc/masked_attention.cu"]
    train_src = ["vidsum_tpu_torch/csrc/block_train.cu"]
    attn_train_src = ["vidsum_tpu_torch/csrc/attention_train.cu"]
    kernels = []
    for route, rep in replaces.items():
        srcs = (attn_train_src if route.startswith("attention_train.")
                else train_src if route in TRAIN_ROUTES
                else block_src if "block" in route else attn_src)
        kernels.append({"name": route.lstrip("_"), "route": "cuda",
                        "source": srcs[0], "sources": srcs, "replaces": rep,
                        "launches": counts[route], **timings[route]})
    print(dev["smi"], flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
