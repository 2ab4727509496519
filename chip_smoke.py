#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

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
4. serve: ``ScoringService`` with seeded flagship weights (d 256, 4 heads,
   4 layers, bf16) takes 13 requests: 320/480/512 frames with auto-KTS,
   1,200 frames, 6,000 frames (past the block envelope: flash) and 16,384
   frames (key-folded), the last two with given shots. Checks: every future
   resolves, summaries are binary and within budget, every route's launch
   counter moved during this phase (counters are zeroed just before it),
   and each request's served scores equal its solo ``make_eval_forward``
   scores bit for bit.
5. the ``kernels`` line, the card's name and power limit, and last
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
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def peaks_for(name: str) -> dict:
    if name not in PEAKS:
        raise RuntimeError(f"no peak rates for {name!r}: add the card's "
                           f"data-sheet peaks to PEAKS")
    return PEAKS[name]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn`` in milliseconds."""
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
    return statistics.median(times)


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

    g, w = got.float(), want.float()
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


def check_close(got, want, tol: dict) -> tuple:
    err, rel = errors(got, want)
    if not within(got, want, tol):
        raise AssertionError(f"kernel disagrees with its plain version: "
                             f"max abs err {err}, relative RMS {rel} "
                             f"(tolerance {tol})")
    return err, rel


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


def library_block(block, d: int, H: int, dtype):
    """nn.TransformerEncoderLayer computing the same function as the block:
    its Q weights are scaled by sqrt(head_dim / d_model), so its
    head_dim**-0.5 scale becomes the reference's d_model**-0.5."""
    import torch
    from torch import nn

    layer = nn.TransformerEncoderLayer(d, H, 4 * d, dropout=0.0,
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
    return layer.to(device=block.norm1.weight.device, dtype=dtype).eval()


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


def reset_counters() -> None:
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk

    for fn in (bk._fused_block, bk._fused_block_grouped, at._flash_attention,
               at._flash_attention_folded, bk.gemm_bias_epilogue,
               at.masked_attention):
        fn.launches = 0


def read_counters() -> dict:
    from vidsum_tpu_torch.ops import attention as at
    from vidsum_tpu_torch.ops import block_kernel as bk

    return {"_fused_block": bk._fused_block.launches,
            "_fused_block_grouped": bk._fused_block_grouped.launches,
            "_flash_attention": at._flash_attention.launches,
            "_flash_attention_folded": at._flash_attention_folded.launches,
            "gemm_bias_epilogue": bk.gemm_bias_epilogue.launches,
            "masked_attention": at.masked_attention.launches}


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
    counts = phase_serve(args.seed)

    replaces = {
        "_fused_block": "vidsum_tpu/ops/block_kernel.py:39",
        "_fused_block_grouped": "vidsum_tpu/ops/block_kernel.py:98",
        "_flash_attention": "vidsum_tpu/ops/attention.py:40",
        "_flash_attention_folded": "vidsum_tpu/ops/attention.py:76",
    }
    block_src = ["vidsum_tpu_torch/csrc/gemm_bias_epilogue.cu",
                 "vidsum_tpu_torch/csrc/masked_attention.cu"]
    attn_src = ["vidsum_tpu_torch/csrc/masked_attention.cu"]
    kernels = []
    for route, rep in replaces.items():
        srcs = block_src if "block" in route else attn_src
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
