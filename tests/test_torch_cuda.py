"""The port's hand-written CUDA kernels against their plain PyTorch versions,
on the card, at small shapes. Every test here needs a CUDA GPU and skips
without one; on a GPU machine run them with
``python -m pytest tests/test_torch_cuda.py -q``. This file imports no JAX,
so it runs where only the port is installed."""

import numpy as np
import pytest
import torch

from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import attention as attn_mod
from vidsum_tpu_torch.ops import block_kernel as bk

pytestmark = pytest.mark.cuda

# Per kernel and dtype: elementwise |got - want| <= atol + rtol |want| and
# relative RMS error <= rel. f32: summation order differs between the
# kernels and the plain versions, nothing else (TF32 is off). bf16 block:
# the JAX tests' bound (tests/test_block_kernel.py) on outputs of size 1;
# bf16 products and attention: one bf16 step (rtol 2**-7) plus an absolute
# bound far below the attention outputs' typical size (means over many keys)
TOL = {
    ("gemm", torch.float32): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("gemm", torch.bfloat16): dict(atol=1e-2, rtol=8e-3, rel=1e-2),
    ("block", torch.float32): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("block", torch.bfloat16): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("attention", torch.float32): dict(atol=1e-5, rtol=1e-5, rel=1e-5),
    ("attention", torch.bfloat16): dict(atol=2e-3, rtol=8e-3, rel=1e-2),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the hand-written kernels have no "
                    "CPU or interpret mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm())


def _within(got, want, kind, dtype):
    tol = TOL[(kind, dtype)]
    g, w = got.float(), want.float()
    return (bool(((g - w).abs() <= tol["atol"] + tol["rtol"] * w.abs()).all())
            and _rel(got, want) <= tol["rel"])


def _close(got, want, kind, dtype):
    tol = TOL[(kind, dtype)]
    torch.testing.assert_close(got.float(), want.float(), atol=tol["atol"],
                               rtol=tol["rtol"])
    assert _rel(got, want) <= tol["rel"]


def _mask(B, N, dev, seed=0):
    rng = np.random.default_rng(seed)
    m = np.zeros((B, N), bool)
    for b in range(B):
        m[b, int(rng.integers(1, N + 1)):] = True   # >= 1 real key per row
    return torch.from_numpy(m).to(dev)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("epilogue,N,K", [("none", 320, 96),
                                          ("relu", 96, 100),
                                          ("residual_ln", 64, 96),
                                          ("residual_ln", 200, 40)])
def test_gemm_bias_epilogue_matches_plain(cuda, dtype, epilogue, N, K):
    """Ragged M, N and K tiles; K = 100 takes the unvectorised loads."""
    g = torch.Generator(device="cpu").manual_seed(1)
    M = 200
    x = torch.randn(M, K, generator=g).to(cuda, dtype)
    w = (torch.randn(N, K, generator=g) / K ** 0.5).to(cuda, dtype)
    b = torch.randn(N, generator=g).to(cuda)
    kw = {}
    if epilogue == "residual_ln":
        kw = dict(residual=torch.randn(M, N, generator=g).to(cuda),
                  ln_g=torch.rand(N, generator=g).to(cuda) + 0.5,
                  ln_b=torch.randn(N, generator=g).to(cuda))
    before = bk.gemm_bias_epilogue.launches
    got_t, got_f = bk.gemm_bias_epilogue(x, w, b, epilogue, want_f32=True,
                                         **kw)
    torch.cuda.synchronize()
    assert bk.gemm_bias_epilogue.launches == before + 1
    want_t, want_f = bk.gemm_bias_epilogue_reference(x, w, b, epilogue,
                                                     want_f32=True, **kw)
    _close(got_f, want_f, "gemm", torch.float32)   # exact products
    _close(got_t, want_t, "gemm", dtype)


def test_kernels_refuse_shapes_no_configuration_has(cuda):
    """The LayerNorm epilogue takes rows of up to 256 (every d_model in the
    repo), the attention kernel head_dim 16 and 64."""
    x = torch.zeros(8, 32, device=cuda)
    w = torch.zeros(320, 32, device=cuda)
    b = torch.zeros(320, device=cuda)
    with pytest.raises(ValueError, match="N <= 256"):
        bk.gemm_bias_epilogue(x, w, b, "residual_ln",
                              residual=torch.zeros(8, 320, device=cuda),
                              ln_g=b, ln_b=b)
    q = torch.zeros(1, 1, 64, 32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        attn_mod.masked_attention(q, q, q, None, 0.1)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_first", [True, False])
@pytest.mark.parametrize("Dh,aligned", [(16, True), (64, True), (64, False)])
def test_masked_attention_matches_plain(cuda, dtype, norm_first, Dh,
                                        aligned):
    """Strided views of one QKV buffer and a ragged last tile; an odd row
    stride takes the unvectorised loads. Each order of rounding P against
    its plain version (the CPU path of the same wrapper)."""
    g = torch.Generator(device="cpu").manual_seed(2)
    B, H, N = 2, 3, 200
    width = 3 * H * Dh + (0 if aligned else 1)
    buf = torch.randn(B, N, width, generator=g).to(cuda, dtype)
    qkv = buf[..., width - 3 * H * Dh:].view(B, N, 3, H, Dh) if aligned \
        else buf[..., 1:].unflatten(-1, (3, H, Dh))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mask = _mask(B, N, cuda)
    got = attn_mod.masked_attention(q, k, v, mask, 0.125,
                                    norm_first=norm_first)
    torch.cuda.synchronize()
    want = attn_mod.masked_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                                     0.125, norm_first=norm_first)
    _close(got, want.to(cuda), "attention", dtype)


@pytest.mark.parametrize("norm_first", [True, False])
def test_bf16_attention_rounds_p_in_its_tpu_kernels_order(cuda, norm_first):
    """normalised P (single-pass and block TPU kernels) or unnormalised P
    of the online fold (folded TPU kernel): the kernel lies at least twice
    as close to its own order's plain version as to the other's, and a
    kernel that drops a key tile fails the tolerance."""
    g = torch.Generator(device="cpu").manual_seed(7)
    B, H, N, Dh = 2, 2, 1024, 64
    q, k, v = (torch.randn(B, H, N, Dh, generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    mask = _mask(B, N, cuda, seed=7)
    mask[:, :N // 2] = False   # >= 8 unpadded key tiles per row
    got = attn_mod.masked_attention(q, k, v, mask, 0.5, norm_first=norm_first)
    normalised = attn_mod.attention_reference(q, k, v, mask, 0.5)
    online = attn_mod.attention_folded_reference(q, k, v, mask, 0.5,
                                                 attn_mod.KEY_TILE)
    own, other = (normalised, online) if norm_first else (online, normalised)
    _close(got, own, "attention", torch.bfloat16)
    assert _rel(got, own) < _rel(got, other) / 2
    dropped = mask.clone()
    dropped[:, :attn_mod.KEY_TILE] = True
    bad = attn_mod.masked_attention(q, k, v, dropped, 0.5,
                                    norm_first=norm_first)
    assert not _within(bad, own, "attention", torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B,N,route", [(2, 128, "_fused_block_grouped"),
                                       (1, 512, "_fused_block")])
def test_fused_encoder_block_routes_match_plain(cuda, dtype, B, N, route):
    cfg = ModelConfig(d_model=64, num_heads=4, num_layers=1)
    block = SimNet(cfg, device=cuda).encoder.module_list[0]
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(B, N, 64, generator=g).to(cuda, dtype)
    mask = _mask(B, N, cuda, seed=3)
    before = getattr(bk, route).launches
    got = bk.fused_encoder_block(block, x, mask, 4, cfg.attn_scale)
    torch.cuda.synchronize()
    assert getattr(bk, route).launches == before + 1
    want = bk.encoder_block_reference(bk.block_weights(block, dtype), x,
                                      mask, 4, cfg.attn_scale)
    _close(got, want, "block", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("folded", [False, True])
def test_flash_routes_match_plain(cuda, dtype, folded):
    g = torch.Generator(device="cpu").manual_seed(4)
    B, H, N, Dh = 2, 2, 256, 64
    q, k, v = (torch.randn(B, H, N, Dh, generator=g).to(cuda, dtype)
               for _ in range(3))
    mask = _mask(B, N, cuda, seed=4)
    if folded:
        got = attn_mod._flash_attention_folded(q, k, v, mask, 0.1, 128)
        want = attn_mod.attention_folded_reference(q, k, v, mask, 0.1,
                                                   attn_mod.KEY_TILE)
    else:
        got = attn_mod._flash_attention(q, k, v, mask, 0.1)
        want = attn_mod.attention_reference(q, k, v, mask, 0.1)
    torch.cuda.synchronize()
    _close(got, want, "attention", dtype)


def test_model_fused_block_matches_dense_on_card(cuda):
    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2)
    model = SimNet(cfg, device=cuda)
    g = torch.Generator(device="cpu").manual_seed(5)
    x = torch.randn(2, 384, 64, generator=g).to(cuda)
    mask = _mask(2, 384, cuda, seed=5)
    with torch.inference_mode():
        got, _ = model(x, mask, attn_impl="fused_block")
        want, _ = model(x, mask, attn_impl="dense")
    _close(got, want, "block", torch.float32)


def test_served_scores_equal_solo_on_card(cuda):
    from vidsum_tpu_torch.data.collate import bucket_length
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.train.steps import make_eval_forward

    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2,
                      compute_dtype="bfloat16")
    model = SimNet(cfg, device=cuda)
    rng = np.random.default_rng(6)
    videos = [rng.normal(size=(n, 64)).astype(np.float32)
              for n in (37, 100, 250, 300, 520)]
    with ScoringService(model, cfg, max_batch=8, max_delay_ms=200.0) as svc:
        results = [f.result(timeout=300) for f in
                   [svc.submit(v, want_summary=False) for v in videos]]
    fwd = make_eval_forward(cfg)
    for v, r in zip(videos, results):
        n = v.shape[0]
        nb = bucket_length(n)
        x = np.full((1, nb, 64), 1000.0, np.float32)
        x[0, :n] = v
        mask = np.ones((1, nb), bool)
        mask[0, :n] = False
        solo = fwd(model, x, mask)[0, :n].float().cpu().numpy()
        np.testing.assert_array_equal(r.scores, solo)


# ------------------------------------------------ the training block chain
# Forward outputs are LayerNorm outputs of size 1 (the block bounds above).
# Gradients are sums over up to B*N rows whose size varies by parameter, so
# their absolute bound is relative to the largest entry: f32 differs from
# the plain version by summation order only (rows with an fc1 input within
# rounding of 0, whose ReLU may branch differently, get a zero cotangent);
# with bf16 inputs dx is rounded to bf16 (one step, 2**-8 relative) while
# the parameter grads stay f32. A whole step, card against CPU, cannot spare
# rows a ReLU flip: "step" holds each grad to the relative RMS such a flip
# leaves upstream (up to ~1e-3), with atol relative to the step's largest
# grad, which also holds a grad that is 0 up to rounding (the key bias's).
TRAIN_TOL = {
    ("fwd", torch.float32): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("fwd", torch.bfloat16): dict(atol=5e-2, rtol=5e-2, rel=1e-2),
    ("grad", torch.float32): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("dx", torch.bfloat16): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
    ("step", torch.float32): dict(atol=1e-4, rtol=1e-3, rel=2e-3),
}
NEAR_ZERO = 2e-4    # of the fc1 inputs' RMS


def _train_within(got, want, kind, dtype):
    tol = TRAIN_TOL[(kind, dtype)]
    g, w = got.float(), want.float()
    atol = tol["atol"] * (float(w.abs().max()) if kind != "fwd" else 1.0)
    return (bool(((g - w).abs() <= atol + tol["rtol"] * w.abs()).all())
            and _rel(got, want) <= tol["rel"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,B,N,grouped", [(64, 2, 128, True),
                                           (64, 1, 512, False),
                                           (256, 4, 256, True),
                                           (256, 1, 640, False)])
def test_block_train_routes_match_plain(cuda, dtype, d, B, N, grouped):
    """Forward, dx and the packed parameter grads of each training route
    against the plain version on the card with the same dropout bits; the
    backward gives identical bits twice; the kernels run at seed + 1 fail
    the bounds."""
    from vidsum_tpu_torch.ops import block_train as bt

    H, rate, seed = 4, 0.3, 1234
    cfg = ModelConfig(d_model=d, num_heads=H, num_layers=1)
    block = SimNet(cfg, device=cuda).encoder.module_list[0]
    g = torch.Generator(device="cpu").manual_seed(8)
    x = torch.randn(B, N, d, generator=g).to(cuda, dtype)
    do = torch.randn(B, N, d, generator=g).to(cuda, dtype)
    mask = _mask(B, N, cuda, seed=8)
    with torch.no_grad():
        w = bt.train_weights(block)
    _, kept = bt._forward_chain(x, mask, seed, w, H, cfg.attn_scale, rate,
                                keep=True)
    a1 = kept["a1"]
    near = (a1.abs() < NEAR_ZERO * a1.pow(2).mean().sqrt()).any(-1)
    do = do.masked_fill(near.view(B, N, 1), 0.0)
    assert bt._pick_train_group(B, N) > 1 if grouped else True
    fwd = bt._fwd_kernel_grouped if grouped else bt._fwd_kernel
    bwd = bt._bwd_kernel_grouped if grouped else bt._bwd_kernel
    f0, b0 = fwd.launches, bwd.launches
    got = fwd(x, mask, seed, w, H, cfg.attn_scale, rate)
    dx, grads = bwd(x, mask, seed, w, do, H, cfg.attn_scale, rate)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1)
    want = bt.block_reference_with_masks(x, w, mask, seed, H,
                                         cfg.attn_scale, rate)
    wdx, wgrads = bt.block_reference_backward(x, w, mask, seed, do, H,
                                              cfg.attn_scale, rate)
    assert got.dtype == dx.dtype == dtype
    assert _train_within(got, want, "fwd", dtype)
    dx_kind = ("dx", dtype) if dtype == torch.bfloat16 else ("grad", dtype)
    assert _train_within(dx, wdx, *dx_kind)
    for name, a, b in zip(bt.TrainWeights._fields, grads, wgrads):
        assert _train_within(a, b, "grad", torch.float32), name
    dx2, grads2 = bwd(x, mask, seed, w, do, H, cfg.attn_scale, rate)
    assert torch.equal(dx, dx2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    bad = fwd(x, mask, seed + 1, w, H, cfg.attn_scale, rate)
    assert not _train_within(bad, want, "fwd", dtype)
    _, bad_grads = bwd(x, mask, seed + 1, w, do, H, cfg.attn_scale, rate)
    assert not _train_within(bad_grads.wqkv, wgrads.wqkv, "grad",
                             torch.float32)


def test_train_step_on_card_matches_cpu(cuda):
    """One finetune step through the fused-block training route on the card
    equals the same step (same seeds) on the CPU's plain path."""
    import copy

    from vidsum_tpu_torch.ops import block_train as bt
    from vidsum_tpu_torch.train.steps import make_finetune_step, make_optimizer

    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2)
    model = SimNet(cfg, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(9)
    x = rng.normal(size=(2, 256, 64)).astype(np.float32)
    t = rng.random((2, 256)).astype(np.float32)
    mask = np.zeros((2, 256), bool)
    mask[1, 200:] = True
    seeds = [11, 22]
    losses, grads = [], []
    for m, dev in ((card, "cuda"), (model, "cpu")):
        step = make_finetune_step(cfg, "fused_block", device=dev)
        opt = make_optimizer(m, 1e-3, 1e-4)
        before = bt._bwd_kernel_grouped.launches
        losses.append(float(step(m, opt, x, t, mask, None,
                                 block_seeds=seeds)))
        if dev == "cuda":
            assert bt._bwd_kernel_grouped.launches == before + 2
        grads.append({k: p.grad.detach().cpu()
                      for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    tol = TRAIN_TOL[("step", torch.float32)]
    gmax = max(float(g.abs().max()) for g in grads[1].values())
    nmax = max(float(g.norm()) for g in grads[1].values())
    for k, want in grads[1].items():
        got = grads[0][k]
        assert bool(((got - want).abs()
                     <= tol["atol"] * gmax + tol["rtol"] * want.abs()).all()), k
        if float(want.norm()) >= 1e-6 * nmax:   # not at rounding level
            assert _rel(got, want) <= tol["rel"], k


# --------------------------------------- the flash-attention training route
# o at the attention bounds above; lse at f32 summation-order level; grads
# atol relative to the tensor's largest entry: f32 at summation-order level,
# bf16 one bf16 step (dq and dk round ds to bf16, the outputs are bf16)
AT_TOL = {
    ("grad", torch.float32): dict(atol=1e-4, rtol=1e-4, rel=1e-5),
    ("grad", torch.bfloat16): dict(atol=1e-2, rtol=1e-2, rel=1e-2),
}


def _at_within(got, want, tol, relative_atol=True):
    g, w = got.float(), want.float()
    atol = tol["atol"] * (float(w.abs().max()) if relative_atol else 1.0)
    return (bool(((g - w).abs() <= atol + tol["rtol"] * w.abs()).all())
            and _rel(got, want) <= tol["rel"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("folded", [False, True])
@pytest.mark.parametrize("Dh", [16, 64])
def test_attention_train_routes_match_plain(cuda, dtype, folded, Dh):
    """Each training attention route's o, lse, dq, dk and dv against its
    plain version on the card with the same dropout bits (the folded one
    over the kernel's 64-key tiles, where it rounds e); two backward runs
    give identical bits; the kernels run at seed + 1 fail the bounds."""
    from vidsum_tpu_torch.ops import attention_train as at

    g = torch.Generator(device="cpu").manual_seed(10)
    B, H, N, rate, seed, scale = 2, 3, 384, 0.3, 4321, 0.125
    q, k, v, do = (torch.randn(B, H, N, Dh, generator=g).to(cuda, dtype)
                   for _ in range(4))
    mask = _mask(B, N, cuda, seed=10)
    kb = at.KEY_TILE
    if folded:
        fwd, bwd = at._fwd_kernel_folded, at._bwd_kernel_folded
        run_f = lambda s: fwd(q, k, v, mask, s, rate, scale, kb)  # noqa
        run_b = lambda s, lse, o: bwd(q, k, v, mask, s, lse, do, o,  # noqa
                                      rate, scale, kb)
        plain_f = at.attention_train_fwd_folded_reference
        plain_b = at.attention_train_bwd_folded_reference
        want_o, want_lse = plain_f(q, k, v, mask, seed, rate, scale, kb)
        want = plain_b(q, k, v, mask, seed, want_lse, do, want_o, rate,
                       scale, kb)
    else:
        fwd, bwd = at._fwd_kernel, at._bwd_kernel
        run_f = lambda s: fwd(q, k, v, mask, s, rate, scale)  # noqa
        run_b = lambda s, lse, o: bwd(q, k, v, mask, s, lse, do, rate,  # noqa
                                      scale)
        want_o, want_lse = at.attention_train_fwd_reference(
            q, k, v, mask, seed, rate, scale)
        want = at.attention_train_bwd_reference(q, k, v, mask, seed,
                                                want_lse, do, rate, scale)
    f0, b0 = fwd.launches, bwd.launches
    o, lse = run_f(seed)
    grads = run_b(seed, want_lse, want_o)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 1)
    assert o.dtype == dtype and all(t.dtype == dtype for t in grads)
    _close(o, want_o, "attention", dtype)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    gtol = AT_TOL[("grad", dtype)]
    for name, a, b in zip("qkv", grads, want):
        assert _at_within(a, b, gtol), f"d{name}: {_rel(a, b)}"
    again = run_b(seed, want_lse, want_o)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    bad_o, _ = run_f(seed + 1)
    assert not _within(bad_o, want_o, "attention", dtype)
    bad = run_b(seed + 1, want_lse, want_o)
    assert not _at_within(bad[2], want[2], gtol)


@pytest.mark.parametrize("folded", [False, True])
def test_flash_attention_dropout_on_card_matches_cpu(cuda, folded,
                                                     monkeypatch):
    """The autograd Function on the card against the same call on the CPU
    (plain versions), f32: output and the grads of q, k and v."""
    from vidsum_tpu_torch.ops import attention_train as at

    if folded:
        monkeypatch.setattr(at, "_single_pass_ok", lambda *a: False)
        monkeypatch.setattr(at, "_pick_key_block", lambda n: at.KEY_TILE)
    g = torch.Generator(device="cpu").manual_seed(11)
    q, k, v, co = (torch.randn(2, 2, 256, 64, generator=g) for _ in range(4))
    mask = _mask(2, 256, "cpu", seed=11)
    results = []
    for dev in (cuda, torch.device("cpu")):
        leaves = [t.to(dev).requires_grad_() for t in (q, k, v)]
        out = at.flash_attention_dropout(*leaves, mask.to(dev), 77, 0.3,
                                         0.125)
        out.backward(co.to(dev))
        results.append([out.detach().cpu()]
                       + [t.grad.cpu() for t in leaves])
    _close(results[0][0], results[1][0], "attention", torch.float32)
    for a, b in zip(results[0][1:], results[1][1:]):
        assert _at_within(a, b, AT_TOL[("grad", torch.float32)])


def test_flash_training_step_on_card_matches_cpu(cuda):
    """Loss and every parameter grad of a flash-route training forward +
    backward, card against CPU, with the same residual and MLP keep masks
    and attention seeds (the bounds of the fused-block step above)."""
    import copy

    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops.losses import mse_with_mask_loss

    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2)
    model = SimNet(cfg, device="cpu")
    card = copy.deepcopy(model).to(cuda)
    rng = np.random.default_rng(12)
    B, N, d = 2, 256, 64
    x = torch.from_numpy(rng.normal(size=(B, N, 64)).astype(np.float32))
    t = torch.from_numpy(rng.random((B, N)).astype(np.float32))
    mask = torch.zeros((B, N), dtype=torch.bool)
    mask[1, 200:] = True
    masks = [{"res1": rng.random((B, N, d)) < 0.7,
              "mlp": rng.random((B, N, 4 * d)) < 0.7,
              "res2": rng.random((B, N, d)) < 0.7} for _ in range(2)]
    losses, grads = [], []
    for m, dev in ((card, cuda), (model, torch.device("cpu"))):
        before = at._bwd_kernel.launches
        scores, _ = m(x.to(dev), mask.to(dev), attn_impl="flash",
                      deterministic=False, dropout_masks=masks,
                      block_seeds=[5, 6])
        loss = mse_with_mask_loss(scores, t.to(dev), mask.to(dev))
        loss.backward()
        if dev.type == "cuda":
            assert at._bwd_kernel.launches == before + 2
        losses.append(float(loss.detach()))
        grads.append({k: p.grad.detach().cpu()
                      for k, p in m.named_parameters()})
    assert abs(losses[0] - losses[1]) <= 1e-5 * abs(losses[1])
    tol = TRAIN_TOL[("step", torch.float32)]
    gmax = max(float(g.abs().max()) for g in grads[1].values())
    nmax = max(float(g.norm()) for g in grads[1].values())
    for k, want in grads[1].items():
        got = grads[0][k]
        assert bool(((got - want).abs()
                     <= tol["atol"] * gmax + tol["rtol"] * want.abs()).all()), k
        if float(want.norm()) >= 1e-6 * nmax:   # not at rounding level
            assert _rel(got, want) <= tol["rel"], k


def test_plain_dropout_is_drawn_on_the_card(cuda):
    """On CUDA inputs the residual and MLP dropout of the plain blocks is
    drawn on the card from a generator seeded by one draw of the given CPU
    generator: reproducible from it, and different for another seed."""
    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=1)
    model = SimNet(cfg, device=cuda)
    x = torch.randn(1, 256, 64, generator=torch.Generator().manual_seed(13))
    x = x.to(cuda)
    runs = [model(x, deterministic=False, attn_impl="flash",
                  generator=torch.Generator().manual_seed(s))[0]
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])


# ------------------------------------------------------------ int8 slice

def _int8_inputs(M, N, K, seed=0):
    g = torch.Generator().manual_seed(seed)
    x8 = torch.randint(-127, 128, (M, K), generator=g, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (N, K), generator=g, dtype=torch.int8)
    sx = torch.rand(M, generator=g) * 0.1 + 1e-3
    sw = torch.rand(N, generator=g) * 0.01 + 1e-4
    b = torch.randn(N, generator=g)
    return x8, sx, w8, sw, b


@pytest.mark.parametrize("M,N,K", [(200, 320, 96), (64, 256, 1024),
                                   (33, 1024, 256)])
def test_int8_gemm_matches_plain_bit_for_bit(cuda, M, N, K):
    """The integer sums are exact and the dequantising epilogue rounds as
    the plain version's tensor ops do: bit for bit at ragged M and N, and
    the probe's shift epilogue too."""
    from vidsum_tpu_torch.ops import quant

    host = _int8_inputs(M, N, K, seed=M)
    x8, sx, w8, sw, b = (t.to(cuda) for t in host)
    before = quant.int8_gemm.launches
    for epi in ("none", "relu"):
        got_t, got_f, _, _ = quant.int8_gemm(x8, sx, w8, sw, b, epi,
                                             out_dtype=torch.bfloat16,
                                             want_f32=True)
        want_t, want_f, _, _ = quant.int8_gemm_reference(
            *host, epi, out_dtype=torch.bfloat16, want_f32=True)
        assert torch.equal(got_f.cpu(), want_f)
        assert torch.equal(got_t.cpu(), want_t)
    got = quant.int8_gemm(x8, None, w8, None, None, "shift")
    assert torch.equal(got.cpu(), quant.int8_gemm_reference(
        host[0], None, host[2], None, None, "shift"))
    torch.cuda.synchronize()
    assert quant.int8_gemm.launches == before + 3


@pytest.mark.parametrize("dtype", DTYPES)
def test_quantize_rows_kernel_matches_plain_bit_for_bit(cuda, dtype):
    from vidsum_tpu_torch.ops import quant

    g = torch.Generator().manual_seed(3)
    x = torch.randn(300, 1024, generator=g) * 10.0
    x[3] = 0.0
    x[5, :6] = torch.tensor([127.0, 0.5, 1.5, 2.5, -0.5, -2.5])
    x[5, 6:] = 0.0
    x = x.to(dtype)
    q, s = quant.quantize_rows(x.to(cuda))
    wq, ws = quant.quantize_rows_reference(x)
    assert torch.equal(q.cpu(), wq) and torch.equal(s.cpu(), ws)


def test_int8_residual_ln_epilogue_and_its_codes(cuda):
    """The LayerNorm moments are summed in another order than the plain
    version's: f32 outputs within summation-order error, and the row codes
    it emits for the next product equal the plain quantizer's codes of the
    kernel's own output."""
    from vidsum_tpu_torch.ops import quant

    M, N, K = 200, 256, 256
    x8, sx, w8, sw, b = (t.to(cuda) for t in _int8_inputs(M, N, K, seed=4))
    g = torch.Generator().manual_seed(4)
    res = torch.randn(M, N, generator=g).to(cuda, torch.bfloat16)
    ln_g = (torch.rand(N, generator=g) + 0.5).to(cuda)
    ln_b = torch.randn(N, generator=g).to(cuda)
    _, y, q, s = quant.int8_gemm(x8, sx, w8, sw, b, "residual_ln",
                                 residual=res, ln_g=ln_g, ln_b=ln_b,
                                 want_f32=True, want_q=True)
    _, want, _, _ = quant.int8_gemm_reference(
        x8, sx, w8, sw, b, "residual_ln", residual=res, ln_g=ln_g,
        ln_b=ln_b, want_f32=True)
    torch.testing.assert_close(y, want, atol=1e-5, rtol=1e-5)
    wq, ws = quant.quantize_rows_reference(y)
    assert torch.equal(q, wq) and torch.equal(s, ws[:, 0])


# the chip-smoke bound of the int8 block (tests/test_quant.py's limits)
INT8_BOUND = dict(median=5e-3, max=5e-2)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,B,N,route", [
    (256, 2, 256, "_fused_block_int8_grouped"),
    (256, 1, 512, "_fused_block_int8"),
    (64, 2, 128, "_fused_block_int8_grouped")])
def test_int8_block_routes_match_plain(cuda, qk_int8, dtype, d, B, N, route):
    from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
    from vidsum_tpu_torch.ops.quant import quantize_block

    cfg = ModelConfig(d_model=d, num_heads=4, num_layers=1)
    block = SimNet(cfg, device=cuda,
                   generator=torch.Generator().manual_seed(d + N)
                   ).encoder.module_list[0]
    qb = quantize_block(block)
    x = torch.randn(B, N, d, generator=torch.Generator().manual_seed(N))
    x = x.to(cuda, dtype)
    mask = _mask(B, N, cuda, seed=N)
    counter = getattr(bk8, route)
    before = counter.launches
    got = bk8.fused_encoder_block_int8(qb, x, mask, 4, d ** -0.5,
                                       qk_int8=qk_int8)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = bk8.int8_block_reference(qb, x, mask, 4, d ** -0.5, qk_int8)
    diff = (got.float() - want.float()).abs()
    assert float(diff.median()) <= INT8_BOUND["median"]
    assert float(diff.max()) <= INT8_BOUND["max"]


def test_int8_route_scores_do_not_depend_on_the_batch(cuda):
    cfg = ModelConfig(compute_dtype="bfloat16", num_layers=2)
    model = SimNet(cfg, device=cuda)
    x = torch.randn(4, 384, 1024, generator=torch.Generator().manual_seed(5))
    x = x.to(cuda)
    mask = _mask(4, 384, cuda, seed=5)
    with torch.inference_mode():
        both, _ = model(x, mask, attn_impl="int8_block")
        solo, _ = model(x[1:2], mask[1:2], attn_impl="int8_block")
    assert torch.equal(both[1:2], solo)


def test_probe_kernels_match_plain(cuda):
    from vidsum_tpu_torch.tools import probe_int8_mma as probe

    xb, wb, xi, wi = probe.inputs(256, 512, 320, seed=1)
    assert torch.equal(probe.mm_int8(xi, wi),
                       probe.mm_int8_reference(xi, wi))
    got = probe.mm_bf16(xb, wb).float()
    want = probe.mm_bf16_reference(xb, wb).float()
    tol = want.abs() * 2.0 ** -7 + 320 * 2.0 ** -24 * torch.matmul(
        xb.float().abs(), wb.float().abs().t())
    assert bool(((got - want).abs() <= tol).all())
