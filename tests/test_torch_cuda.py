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
                                          ("residual_ln", 200, 40),
                                          ("residual_ln", 512, 96)])
def test_gemm_bias_epilogue_matches_plain(cuda, dtype, epilogue, N, K):
    """Ragged M, N and K tiles; K = 100 takes the unvectorised loads; rows
    of N = 512 (d_model 512) take the LayerNorm row kernel."""
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
    """No kernel refuses a width the JAX package takes: the LayerNorm
    epilogue's rows of 800 and 1,056 columns (past 1,024 the looping row
    kernel) and d 200 (off the 32-column grid) in both dtypes, and the
    serving attention at head_dim 48 (zero-padded to 64), 160, 256 and 320
    (128-column slices) in both dtypes. Each launch moves its counter and
    matches the plain version at its bound."""
    g = torch.Generator(device="cpu").manual_seed(3)
    for dtype in DTYPES:
        for n in (200, 800, 1056):
            x = torch.randn(8, 64, generator=g).to(cuda, dtype)
            w = (torch.randn(n, 64, generator=g) / 8).to(cuda, dtype)
            b = torch.randn(n, generator=g).to(cuda)
            kw = dict(residual=torch.randn(8, n, generator=g).to(cuda),
                      ln_g=torch.rand(n, generator=g).to(cuda) + 0.5,
                      ln_b=b)
            before = bk.gemm_bias_epilogue.launches
            got_t, got_f = bk.gemm_bias_epilogue(x, w, b, "residual_ln",
                                                 want_f32=True, **kw)
            torch.cuda.synchronize()
            assert bk.gemm_bias_epilogue.launches == before + 1
            want_t, want_f = bk.gemm_bias_epilogue_reference(
                x, w, b, "residual_ln", want_f32=True, **kw)
            _close(got_f, want_f, "gemm", torch.float32)
            _close(got_t, want_t, "gemm", dtype)
    for Dh in (48, 160, 256, 320):
        for dtype in DTYPES:
            q, k, v = (torch.randn(2, 2, 192, Dh, generator=g).to(cuda, dtype)
                       for _ in range(3))
            mask = _mask(2, 192, cuda, seed=Dh)
            before = attn_mod.masked_attention.launches
            got = attn_mod.masked_attention(q, k, v, mask, Dh ** -0.5)
            torch.cuda.synchronize()
            assert attn_mod.masked_attention.launches == before + 1
            assert got.shape == q.shape
            _close(got, attn_mod.attention_reference(q, k, v, mask,
                                                     Dh ** -0.5),
                   "attention", dtype)


# ------------------------------- the serving block's bf16 GEMM on wgmma

def _gemm_case(dev, M, N, K, epilogue, res_dtype=torch.float32, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(dev, torch.bfloat16)
    w = (torch.randn(N, K, generator=g) / K ** 0.5).to(dev, torch.bfloat16)
    b = torch.randn(N, generator=g).to(dev)
    kw = {}
    if epilogue == "residual_ln":
        kw = dict(residual=torch.randn(M, N, generator=g).to(dev, res_dtype),
                  ln_g=torch.rand(N, generator=g).to(dev) + 0.5,
                  ln_b=torch.randn(N, generator=g).to(dev))
    return x, w, b, kw


def _gemm_shape(monkeypatch, rows):
    """Forces the wgmma kernel's CTA rows (None: the wrapper's rule)."""
    monkeypatch.undo()
    if rows is not None:
        monkeypatch.setattr(bk, "gemm_cta_rows", lambda *a: rows)


@pytest.mark.parametrize("epilogue,M,N,K,res_dtype", [
    ("none", 200, 320, 96, None),          # ragged M, N and K tiles
    ("none", 130, 1, 256, None),           # the score head: N 1
    ("relu", 333, 1000, 264, None),
    ("residual_ln", 200, 64, 96, torch.bfloat16),     # d 64
    ("residual_ln", 257, 128, 512, torch.float32),    # d 128, K 4d
    ("residual_ln", 300, 256, 1024, torch.float32),   # d 256, K 4d
    ("residual_ln", 300, 256, 256, torch.bfloat16),   # d 256, x's residual
    ("residual_ln", 200, 200, 40, torch.float32),     # N 200, K < 64
    ("residual_ln", 200, 512, 96, torch.bfloat16),    # d 512: the row kernel
])
def test_wgmma_gemm_matches_plain(cuda, monkeypatch, epilogue, M, N, K,
                                  res_dtype):
    """The wgmma kernel (never the fallback, by its counter) against the
    plain version in both CTA shapes, which give the same bits."""
    x, w, b, kw = _gemm_case(cuda, M, N, K, epilogue, res_dtype)
    want_t, want_f = bk.gemm_bias_epilogue_reference(x, w, b, epilogue,
                                                     want_f32=True, **kw)
    outs = []
    for rows in (64, 128):
        _gemm_shape(monkeypatch, rows)
        before = (bk.gemm_bias_epilogue.launches,
                  bk.gemm_bias_epilogue.fallback_launches)
        got_t, got_f = bk.gemm_bias_epilogue(x, w, b, epilogue,
                                             want_f32=True, **kw)
        torch.cuda.synchronize()
        assert (bk.gemm_bias_epilogue.launches,
                bk.gemm_bias_epilogue.fallback_launches) == (
                    before[0] + 1, before[1])
        _close(got_f, want_f, "gemm", torch.float32)   # exact products
        _close(got_t, want_t, "gemm", torch.bfloat16)
        outs.append((got_t, got_f))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("case", ["k100", "row_stride_100", "odd_base"])
def test_gemm_fallback_takes_what_tma_cannot(cuda, case):
    """K = 100, a view with a row stride of 100 and a base off 16 bytes take
    the mma.sync fallback (its counter moves) and match the plain version;
    a view with a row stride of 104 takes the wgmma kernel."""
    M, N, K = 200, 256, 100 if case == "k100" else 96
    x, w, b, kw = _gemm_case(cuda, M, N, K, "residual_ln")
    if case == "row_stride_100":
        x = torch.zeros(M, 100, device=cuda, dtype=x.dtype).copy_(
            torch.nn.functional.pad(x, (0, 4)))[:, :K]
    elif case == "odd_base":
        flat = torch.zeros(M * K + 1, device=cuda, dtype=x.dtype)
        x = flat[1:].view(M, K).copy_(x)
    assert not bk.gemm_takes_wgmma(x, w)
    before = bk.gemm_bias_epilogue.fallback_launches
    got_t, got_f = bk.gemm_bias_epilogue(x, w, b, "residual_ln",
                                         want_f32=True, **kw)
    torch.cuda.synchronize()
    assert bk.gemm_bias_epilogue.fallback_launches == before + 1
    want_t, want_f = bk.gemm_bias_epilogue_reference(x, w, b, "residual_ln",
                                                     want_f32=True, **kw)
    _close(got_f, want_f, "gemm", torch.float32)
    _close(got_t, want_t, "gemm", torch.bfloat16)
    wide = torch.zeros(M, 104, device=cuda, dtype=x.dtype)[:, :96]
    wide.copy_(torch.randn(M, 96, device=cuda).to(x.dtype))
    before = bk.gemm_bias_epilogue.fallback_launches
    got = bk.gemm_bias_epilogue(wide, w[:, :96].contiguous(), b)[0]
    torch.cuda.synchronize()
    assert bk.gemm_bias_epilogue.fallback_launches == before
    _close(got, bk.gemm_bias_epilogue_reference(
        wide, w[:, :96].contiguous(), b)[0], "gemm", torch.bfloat16)


@pytest.mark.parametrize("epilogue,N,K", [("none", 768, 256),
                                          ("relu", 1024, 256),
                                          ("residual_ln", 256, 1024)])
def test_gemm_row_bits_do_not_depend_on_m_or_the_cta_shape(
        cuda, monkeypatch, epilogue, N, K):
    """A row's output is bit-equal at M 200 and M 16,384 and in both CTA
    shapes (served scores equal solo scores)."""
    x, w, b, kw = _gemm_case(cuda, 16384, N, K, epilogue, torch.float32)
    runs = []
    for rows in (None, 64, 128):
        _gemm_shape(monkeypatch, rows)
        for M in (16384, 200):
            sub = {k: (v[:M] if k == "residual" else v)
                   for k, v in kw.items()}
            y, _ = bk.gemm_bias_epilogue(x[:M], w, b, epilogue, **sub)
            runs.append(y[:200])
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_first", [True, False])
@pytest.mark.parametrize("Dh,aligned", [(16, True), (32, True), (64, True),
                                        (64, False), (96, True), (128, True),
                                        (48, True), (80, False),
                                        (112, True), (160, True),
                                        (256, False), (320, True)])
@pytest.mark.parametrize("N,valid", [(200, None), (520, (70, 455))])
def test_masked_attention_matches_plain(cuda, dtype, norm_first, Dh,
                                        aligned, N, valid):
    """Strided views of one QKV buffer and a ragged last tile; an odd row
    stride takes the unvectorised loads. Each order of rounding P against
    its plain version (the CPU path of the same wrapper). N 520 with valid
    lengths (70, 455): element 0's padded tail spans six wholly padded
    64-key tiles and a ragged one, element 1's the ragged one (the tiles
    the bf16 kernel skips), and the mask rows lie off 16-byte
    boundaries."""
    g = torch.Generator(device="cpu").manual_seed(2)
    B, H = 2, 3
    width = 3 * H * Dh + (0 if aligned else 1)
    buf = torch.randn(B, N, width, generator=g).to(cuda, dtype)
    qkv = buf[..., width - 3 * H * Dh:].view(B, N, 3, H, Dh) if aligned \
        else buf[..., 1:].unflatten(-1, (3, H, Dh))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    if valid is None:
        mask = _mask(B, N, cuda)
    else:
        mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
        for b, n in enumerate(valid):
            mask[b, n:] = True
    got = attn_mod.masked_attention(q, k, v, mask, 0.125,
                                    norm_first=norm_first)
    torch.cuda.synchronize()
    want = attn_mod.masked_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                                     0.125, norm_first=norm_first)
    _close(got, want.to(cuda), "attention", dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("norm_first", [True, False])
def test_masked_attention_element_with_no_unpadded_key_gives_zeros(
        cuda, dtype, norm_first):
    """An element whose keys are all padded walks no key tile and is
    written as 0 in both orders (the folded TPU kernel's behaviour; the
    single pass would give NaN there, and the serving path never sends such
    an element); the other element matches its plain version."""
    g = torch.Generator(device="cpu").manual_seed(5)
    B, H, N, Dh = 2, 4, 384, 64
    q, k, v = (torch.randn(B, H, N, Dh, generator=g).to(cuda, dtype)
               for _ in range(3))
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[0] = True
    mask[1, 300:] = True
    got = attn_mod.masked_attention(q, k, v, mask, 0.125,
                                    norm_first=norm_first)
    torch.cuda.synchronize()
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    want = attn_mod.masked_attention(q[1:].cpu(), k[1:].cpu(), v[1:].cpu(),
                                     mask[1:].cpu(), 0.125,
                                     norm_first=norm_first)
    _close(got[1:], want.to(cuda), "attention", dtype)


@pytest.mark.parametrize("norm_first", [True, False])
def test_bf16_attention_cta_shapes_agree_at_a_small_grid(cuda, norm_first,
                                                         monkeypatch):
    """(1, 4, 1,280, 64), the attention of a 1,200-frame request's blocks:
    40 CTAs of 128 rows would not fill the card, so the wrapper takes
    64-row CTAs.
    Both shapes give the plain version's result and the same bits: a row's
    arithmetic does not depend on the CTA that holds it."""
    g = torch.Generator(device="cpu").manual_seed(6)
    B, H, N, Dh = 1, 4, 1280, 64
    q, k, v = (torch.randn(B, H, N, Dh, generator=g).to(cuda, torch.bfloat16)
               for _ in range(3))
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[:, 1200:] = True
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert attn_mod.mma_cta_rows(B, H, N, Dh, sms) == 64
    got = attn_mod.masked_attention(q, k, v, mask, 0.125,
                                    norm_first=norm_first)
    for rows in (64, 128):
        monkeypatch.setattr(attn_mod, "mma_cta_rows", lambda *a: rows)
        other = attn_mod.masked_attention(q, k, v, mask, 0.125,
                                          norm_first=norm_first)
        assert torch.equal(other, got)
    want = attn_mod.masked_attention(q.cpu(), k.cpu(), v.cpu(), mask.cpu(),
                                     0.125, norm_first=norm_first)
    _close(got, want.to(cuda), "attention", torch.bfloat16)


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
@pytest.mark.parametrize("d", [64, 384, 512])
@pytest.mark.parametrize("B,N,route", [(2, 128, "_fused_block_grouped"),
                                       (1, 512, "_fused_block")])
def test_fused_encoder_block_routes_match_plain(cuda, dtype, d, B, N, route):
    """d 64 (head_dim 16), d 384 (head_dim 96) and d 512 (head_dim 128;
    both with LayerNorm rows past the GEMM's CTA tile), 4 heads."""
    cfg = ModelConfig(d_model=d, num_heads=4, num_layers=1)
    block = SimNet(cfg, device=cuda).encoder.module_list[0]
    g = torch.Generator(device="cpu").manual_seed(3)
    x = torch.randn(B, N, d, generator=g).to(cuda, dtype)
    mask = _mask(B, N, cuda, seed=3)
    before = getattr(bk, route).launches
    if bk.fused_block_supported(B, N, d, x.element_size()):
        got = bk.fused_encoder_block(block, x, mask, 4, cfg.attn_scale)
    else:  # past the copied TPU envelope (d 512): the entry point itself
        got = getattr(bk, route)(bk.block_weights(block, dtype), x, mask, 4,
                                 cfg.attn_scale)
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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("N", [200, 1000])
def test_flash_attention_takes_the_kernel_off_the_128_tile(cuda, dtype, N):
    """A CUDA tensor whose length is not a multiple of 128 still launches
    the single-pass kernel (the CPU takes the plain path there, as JAX)."""
    g = torch.Generator(device="cpu").manual_seed(6)
    q, k, v = (torch.randn(1, 4, N, 64, generator=g).to(cuda, dtype)
               for _ in range(3))
    mask = _mask(1, N, cuda, seed=6)
    before = attn_mod._flash_attention.launches
    got = attn_mod.flash_attention(q, k, v, mask, 0.1)
    torch.cuda.synchronize()
    assert attn_mod._flash_attention.launches == before + 1
    _close(got, attn_mod.attention_reference(q, k, v, mask, 0.1),
           "attention", dtype)


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


# ------------------------------------------- the f32 serving chain (FMA)
# The block's four products at d 256 (K -> N), at the flagship's (32, 512)
# and (8, 256) rows; d 512 and 768 (the wide LayerNorm route); an M that is
# no multiple of any tile, with a K and N off the tiles too.
F32_PRODUCTS = [
    ("none", 256, 768), ("residual_ln", 256, 256), ("relu", 256, 1024),
    ("residual_ln", 1024, 256)]


def _f32_gemm_case(dev, M, N, K, epilogue, seed=1):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn(M, K, generator=g).to(dev)
    w = (torch.randn(N, K, generator=g) / K ** 0.5).to(dev)
    b = torch.randn(N, generator=g).to(dev)
    kw = {}
    if epilogue == "residual_ln":
        kw = dict(residual=torch.randn(M, N, generator=g).to(dev),
                  ln_g=torch.rand(N, generator=g).to(dev) + 0.5,
                  ln_b=torch.randn(N, generator=g).to(dev))
    return x, w, b, kw


@pytest.mark.parametrize("tile", [64, 128])
@pytest.mark.parametrize("epilogue,K,N,M", [
    *((e, K, N, M) for e, K, N in F32_PRODUCTS for M in (32 * 512,
                                                         8 * 256)),
    ("residual_ln", 512, 512, 1000), ("residual_ln", 768, 768, 1000),
    ("residual_ln", 3072, 768, 1000), ("none", 100, 320, 1001),
    ("none", 1024, 1, 777)])
def test_f32_gemm_matches_plain(cuda, monkeypatch, tile, epilogue, K, N, M):
    """The FMA kernel (its 16-byte loads: no fallback counted) in both tiles
    against the plain version at the f32 bound; a product with one 16-deep
    k tile zeroed (a skipped k tile) fails the bound."""
    monkeypatch.setattr(bk, "gemm_f32_tile", lambda *a: tile)
    x, w, b, kw = _f32_gemm_case(cuda, M, N, K, epilogue)
    assert bk.gemm_takes_vec4(x, w)
    before = (bk.gemm_bias_epilogue.launches,
              bk.gemm_bias_epilogue.fallback_launches)
    got, _ = bk.gemm_bias_epilogue(x, w, b, epilogue, **kw)
    torch.cuda.synchronize()
    assert (bk.gemm_bias_epilogue.launches,
            bk.gemm_bias_epilogue.fallback_launches) == (before[0] + 1,
                                                         before[1])
    want, _ = bk.gemm_bias_epilogue_reference(x, w, b, epilogue, **kw)
    _close(got, want, "gemm", torch.float32)
    skipped = x.clone()
    skipped[:, 16:32] = 0.0
    bad, _ = bk.gemm_bias_epilogue(skipped, w, b, epilogue, **kw)
    assert not _within(bad, want, "gemm", torch.float32)


@pytest.mark.parametrize("case", ["k98", "row_stride_98", "odd_base"])
def test_f32_gemm_scalar_loads_are_counted_and_give_the_same_bits(cuda,
                                                                   case):
    """K 98, a row stride of 98 and a base off 16 bytes take the FMA
    kernel's scalar loads (the fallback counter moves); every output is the
    same FMAs in the same k order, so where the operands also fit the
    16-byte loads (a contiguous copy) the bits are equal."""
    M, N, K = 300, 256, 98 if case == "k98" else 96
    x, w, b, kw = _f32_gemm_case(cuda, M, N, K, "residual_ln")
    xs = x
    if case == "row_stride_98":
        xs = torch.zeros(M, 98, device=cuda)[:, :K]
        xs.copy_(x)
    elif case == "odd_base":
        xs = torch.zeros(M * K + 1, device=cuda)[1:].view(M, K)
        xs.copy_(x)
    assert not bk.gemm_takes_vec4(xs, w)
    before = bk.gemm_bias_epilogue.fallback_launches
    got, _ = bk.gemm_bias_epilogue(xs, w, b, "residual_ln", **kw)
    torch.cuda.synchronize()
    assert bk.gemm_bias_epilogue.fallback_launches == before + 1
    want, _ = bk.gemm_bias_epilogue_reference(x, w, b, "residual_ln", **kw)
    _close(got, want, "gemm", torch.float32)
    if case != "k98":
        assert torch.equal(got, bk.gemm_bias_epilogue(
            x, w, b, "residual_ln", **kw)[0])


@pytest.mark.parametrize("epilogue,K,N", F32_PRODUCTS)
def test_f32_gemm_row_bits_do_not_depend_on_the_batch(cuda, monkeypatch,
                                                      epilogue, K, N):
    """The rows of one request (256) computed alone and inside a batch of 8
    (2,048 rows) and of 32 x 512, by the tile rule and in each tile:
    bit-equal (served == solo)."""
    x, w, b, kw = _f32_gemm_case(cuda, 32 * 512, N, K, epilogue, seed=4)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert bk.gemm_f32_tile(32 * 512, N, sms) == 128
    assert bk.gemm_f32_tile(256, N, sms) == 64
    pick = bk.gemm_f32_tile
    runs = []
    for tile in (None, 64, 128):
        monkeypatch.setattr(bk, "gemm_f32_tile",
                            pick if tile is None else lambda *a: tile)
        for M in (32 * 512, 8 * 256, 256):
            sub = {k: (v[:M] if k == "residual" else v)
                   for k, v in kw.items()}
            runs.append(bk.gemm_bias_epilogue(x[:M], w, b, epilogue,
                                              **sub)[0][:256])
    torch.cuda.synchronize()
    assert all(torch.equal(runs[0], r) for r in runs[1:])


@pytest.mark.parametrize("norm_first", [True, False])
@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128, 48, 112, 160, 256])
@pytest.mark.parametrize("B,H,N", [(1, 4, 1280), (1, 4, 6016),
                                   (1, 4, 16384), (2, 3, 1000), (3, 2, 77)])
def test_f32_attention_matches_plain(cuda, norm_first, Dh, B, H, N):
    """The FMA forward on the serving path (no fallback counted) against
    each route's plain version at the attention bound: N 1,280, 6,016 and
    16,384 (the serve phase's shapes) and N 1,000 and 77, off the 64-key
    tile (a ragged last tile, mask rows off 16 bytes); views of one fused
    QKV buffer written into a (B, N, d) buffer, as the block does. A kernel
    that drops the first key tile fails the bound."""
    g = torch.Generator(device="cpu").manual_seed(N + Dh)
    d = H * Dh
    qkv = (torch.randn(B, N, 3 * d, generator=g).to(cuda)
           .view(B, N, 3, H, Dh))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    out = torch.empty(B, N, d, device=cuda).view(B, N, H, Dh).transpose(1, 2)
    mask = _mask(B, N, cuda, seed=N)
    mask[:, :min(N, 70)] = False   # the first key tile is live
    scale = Dh ** -0.5
    before = (attn_mod.masked_attention.launches,
              attn_mod.masked_attention.fallback_launches)
    got = attn_mod.masked_attention(q, k, v, mask, scale, out=out,
                                    norm_first=norm_first)
    torch.cuda.synchronize()
    assert (attn_mod.masked_attention.launches,
            attn_mod.masked_attention.fallback_launches) == (before[0] + 1,
                                                             before[1])
    want = (attn_mod.attention_reference(q, k, v, mask, scale) if norm_first
            else attn_mod.attention_folded_reference(q, k, v, mask, scale,
                                                     attn_mod.KEY_TILE))
    _close(got, want, "attention", torch.float32)
    if N > attn_mod.KEY_TILE:
        dropped = mask.clone()
        dropped[:, :attn_mod.KEY_TILE] = True
        bad = attn_mod.masked_attention(q, k, v, dropped, scale,
                                        norm_first=norm_first)
        assert not _within(bad, want, "attention", torch.float32)


def test_f32_attention_row_bits_do_not_depend_on_the_batch(cuda):
    """(8, 4, 2,048, 64) takes 16-deep CTAs (the grid fills the card), one
    element alone 8-deep ones: its rows are bit-equal either way (served ==
    solo)."""
    g = torch.Generator(device="cpu").manual_seed(12)
    B, H, N, Dh = 8, 4, 2048, 64
    q, k, v = (torch.randn(B, H, N, Dh, generator=g).to(cuda)
               for _ in range(3))
    mask = _mask(B, N, cuda, seed=12)
    both = attn_mod.masked_attention(q, k, v, mask, 0.125)
    for i in (0, 5):
        solo = attn_mod.masked_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                         mask[i:i + 1], 0.125)
        assert torch.equal(both[i:i + 1], solo)


def test_f32_attention_stages_views_off_16_bytes(cuda):
    """A view with an odd row stride fails ``attention_layout_ok``: the
    wrapper stages aligned copies (the fallback counter moves) and writes
    the same bits as the aligned route."""
    g = torch.Generator(device="cpu").manual_seed(13)
    B, H, N, Dh = 2, 2, 300, 64
    buf = torch.randn(B, N, 3 * H * Dh + 1, generator=g).to(cuda)
    qkv = buf[..., 1:].unflatten(-1, (3, H, Dh))
    q, k, v = (qkv[:, :, i].transpose(1, 2) for i in range(3))
    mask = _mask(B, N, cuda, seed=13)
    assert not attn_mod.attention_layout_ok(q, k, v)
    before = attn_mod.masked_attention.fallback_launches
    got = attn_mod.masked_attention(q, k, v, mask, 0.125)
    torch.cuda.synchronize()
    assert attn_mod.masked_attention.fallback_launches == before + 1
    same = attn_mod.masked_attention(*(t.contiguous() for t in (q, k, v)),
                                     mask, 0.125)
    assert torch.equal(got, same)


@pytest.mark.parametrize("Dh", [64, 96])
def test_f32_int8_attention_with_qk8_matches_plain(cuda, Dh):
    """The f32 int8 block's attention with qk_int8 (int8 Q/K codes, per-row
    scales): the QK8 kernel against its plain version."""
    g = torch.Generator(device="cpu").manual_seed(14)
    B, H, N = 2, 2, 320
    q8, k8 = (torch.randint(-127, 128, (B, H, N, Dh), generator=g,
                            dtype=torch.int8).to(cuda) for _ in range(2))
    qs, ks = (torch.rand(B, H, N, generator=g).to(cuda) * 0.01
              for _ in range(2))
    v = torch.randn(B, H, N, Dh, generator=g).to(cuda)
    mask = _mask(B, N, cuda, seed=14)
    got = attn_mod.masked_attention(q8, k8, v, mask, Dh ** -0.5,
                                    qk_scales=(qs, ks))
    want = attn_mod.attention_q8_reference(q8, k8, v, qs, ks, mask,
                                           Dh ** -0.5, torch.float32)
    _close(got, want, "attention", torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,heads", [(384, 4), (768, 8)])
def test_head96_models_take_the_kernel_routes(cuda, dtype, d, heads):
    """``ModelConfig(d_model=384, num_heads=4)`` and d 768 with 8 heads
    (head_dim 96, the C1 shapes): the fused-block and flash routes on the
    card against the same routes' plain versions on the CPU (f32 at the
    block bound; bf16 sigmoid scores at the int8 block's limits, as
    chip_smoke.py's d 512 check holds them)."""
    import copy

    cfg = ModelConfig(in_features=64, d_model=d, num_heads=heads,
                      num_layers=1, compute_dtype=str(dtype).split(".")[1])
    model = SimNet(cfg, generator=torch.Generator().manual_seed(d))
    g = torch.Generator(device="cpu").manual_seed(d)
    x = torch.randn(2, 256, 64, generator=g)
    mask = _mask(2, 256, "cpu", seed=d)
    cpu = copy.deepcopy(model).to("cpu")
    model = model.to(cuda)
    with torch.inference_mode():
        for impl in ("fused_block", "flash"):
            got, _ = model(x.to(cuda), mask.to(cuda), attn_impl=impl)
            want, _ = cpu(x, mask, attn_impl=impl)
            if dtype == torch.float32:
                _close(got.cpu(), want, "block", dtype)
            else:
                diff = (torch.sigmoid(got.float().cpu())
                        - torch.sigmoid(want.float())).abs()
                assert float(diff.median()) <= INT8_BOUND["median"]
                assert float(diff.max()) <= INT8_BOUND["max"]


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
                                           (256, 1, 640, False),
                                           (384, 2, 256, True),
                                           (512, 4, 256, True),
                                           (512, 1, 512, False)])
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


@pytest.mark.parametrize("layout", ["tb", "plain", "ta"])
@pytest.mark.parametrize("epilogue,splits", [("bias", 1), ("bias", 3),
                                             ("relu_drop", 1),
                                             ("drop_relu_bwd", 1)])
@pytest.mark.parametrize("K", [1000, 1001])
def test_bt_gemm_matches_f64_at_summation_order(cuda, layout, epilogue,
                                                splits, K):
    """``bt_gemm`` in the forward's layout (``tb``: A . W^T), the dX
    products' (A . W) and the dW products' (``ta``: X^T . dY), with every
    epilogue and split-K, against torch.matmul in f64: within the bound of
    an f32 sum of K products in any order, (K + 2) 2^-24 sum |a||b| (the
    dropout's kscale times that, plus one rounding of the scaled value).
    K 1001 takes the scalar loads (row strides not a multiple of 4). Two
    runs give identical bits."""
    from vidsum_tpu_torch.ops import block_train as bt

    M, N, R, rate, seed, site = 300, 200, 100, 0.3, 77, bt.S_MLP
    g = torch.Generator().manual_seed(K)
    a = torch.randn(M, K, generator=g)
    w = torch.randn(N, K, generator=g)
    bias = torch.randn(N, generator=g)
    addend = torch.randn(M, N, generator=g)
    aux = torch.randn(M, N, generator=g)
    a_op = a.t().contiguous() if layout == "ta" else a
    b_op = w if layout == "tb" else w.t().contiguous()
    dr = bt._Drop(seed, R, bt._threshold(rate), bt._keep_scale(rate))
    kw = dict(ta=layout == "ta", tb=layout == "tb", epilogue=epilogue,
              splits=splits)
    if epilogue == "bias":
        kw.update(bias=bias.to(cuda), addend=addend.to(cuda))
    elif epilogue == "relu_drop":
        kw.update(bias=bias.to(cuda), dr=dr, site=site, keep_pre=True)
    else:
        kw.update(dr=dr, site=site, aux=aux.to(cuda))
    runs = [bt._gemm(a_op.to(cuda), b_op.to(cuda), **kw) for _ in range(2)]
    torch.cuda.synchronize()
    got = runs[0][0] if epilogue == "relu_drop" else runs[0]
    again = runs[1][0] if epilogue == "relu_drop" else runs[1]
    assert torch.equal(got, again)
    prod = a.double() @ w.double().t()
    size = a.double().abs() @ w.double().abs().t()
    m = torch.arange(M)
    keep = bt._keep_bits(seed, torch.tensor(site), (m // R)[:, None],
                         (m % R)[:, None], torch.arange(N)[None, :], rate)
    ks = dr.kscale
    if epilogue == "bias":
        want = prod + bias.double() + addend.double()
        size = size + bias.double().abs() + addend.double().abs()
    elif epilogue == "relu_drop":
        pre = prod + bias.double()
        size = size + bias.double().abs()
        tol_pre = (K + 2) * 2.0 ** -24 * size
        assert bool(((runs[0][1].cpu().double() - pre).abs()
                     <= tol_pre).all())
        want = torch.where(keep, pre.clamp_min(0) * ks, 0.0)
    else:
        want = torch.where(keep & (aux > 0), prod * ks, 0.0)
    scale = ks if epilogue != "bias" else 1.0
    tol = scale * (K + 2) * 2.0 ** -24 * size + 2.0 ** -23 * want.abs()
    err = (got.cpu().double() - want).abs()
    assert bool((err <= tol).all()), float((err - tol).max())


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


# ------------------------------- the training batch's staging and its copy
# Each step's host batch reaches the card through a two-slot ring of pinned
# buffers and a copy that does not block (train.steps.move_batch)
STAGE_CFG = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2)


def _stage_batch(kind, B, N, seed):
    from vidsum_tpu_torch.models.pretrain import VIDEO_REP_DIM

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, STAGE_CFG.in_features)).astype(np.float32)
    mask = np.arange(N)[None, :] >= rng.integers(1, N + 1, size=B)[:, None]
    x[mask] = 1000.0
    y = (rng.random((B, N)) if kind == "finetune" else
         rng.normal(size=(B, VIDEO_REP_DIM))).astype(np.float32)
    return x, y, mask


def _stage_setup(kind, dev, batch):
    """A fresh model (the same weights every call), its optimizer and its
    step on the fused-block route."""
    from vidsum_tpu_torch.config import PretrainConfig
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    from vidsum_tpu_torch.train.steps import (make_finetune_step,
                                              make_optimizer,
                                              make_pretrain_step)

    if kind == "finetune":
        model = SimNet(STAGE_CFG, device=dev)
        return (model, make_optimizer(model, 1e-3, 1e-4),
                make_finetune_step(STAGE_CFG, "fused_block", device=dev))
    pcfg = PretrainConfig(batch_size=batch)
    model = PretrainModel(STAGE_CFG, pcfg, device=dev)
    opt = make_optimizer([("encoder." + n, p) for n, p in
                          model.encoder.named_parameters()], 1e-3, 5e-4)
    return model, opt, make_pretrain_step(
        STAGE_CFG, pcfg, lambda n: 1e-3 / (n + 1), "fused_block", device=dev)


def _stage_run(kind, dev, shapes, feed, trace_dir=None):
    """``len(shapes)`` steps of :func:`_stage_setup`'s model, fed each batch
    as numpy arrays (``"numpy"``), as numpy arrays overwritten as soon as
    the step returns (``"overwritten"``) or as tensors already on the card
    (``"device"``); the steps alone under ``utils.profiling.trace(
    trace_dir)``. Returns (step outputs, model, optimizer), synchronised."""
    from vidsum_tpu_torch.utils import profiling

    model, opt, step = _stage_setup(kind, dev, shapes[0][0])
    gen = torch.Generator().manual_seed(17)
    batches = [_stage_batch(kind, B, N, seed=i)
               for i, (B, N) in enumerate(shapes)]
    if feed == "device":
        batches = [tuple(torch.from_numpy(a).to(dev) for a in arrays)
                   for arrays in batches]
    torch.cuda.synchronize()
    outs = []
    with profiling.trace(trace_dir):
        for arrays in batches:
            outs.append(step(model, opt, *arrays, gen))
            if feed == "overwritten":
                for a in arrays:
                    a[...] = True if a.dtype == bool else np.nan
    torch.cuda.synchronize()
    return outs, model, opt


def _assert_same_training_state(got, want):
    """Outputs, parameters, gradients and Adam state bit for bit."""
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b), (a, b)
    for (n, p), (_, q) in zip(got[1].named_parameters(),
                              want[1].named_parameters()):
        assert torch.equal(p, q), n
        assert (p.grad is None) == (q.grad is None), n
        assert p.grad is None or torch.equal(p.grad, q.grad), n
    sa, sb = got[2].state_dict()["state"], want[2].state_dict()["state"]
    assert sa.keys() == sb.keys() and sa
    for k in sa:
        for key, v in sa[k].items():
            assert torch.equal(v, sb[k][key]), (k, key)


STAGE_SHAPES = [(4, 256), (4, 128), (4, 384)]


@pytest.mark.parametrize("kind", ["finetune", "pretrain"])
def test_staged_steps_equal_steps_fed_on_the_card(cuda, kind):
    """Numpy batches, staged through the ring, train bit for bit as the same
    batches handed over already on the card."""
    from vidsum_tpu_torch.train.steps import move_batch

    before = move_batch.staged, move_batch.direct
    staged = _stage_run(kind, cuda, STAGE_SHAPES, "numpy")
    mid = move_batch.staged, move_batch.direct
    _assert_same_training_state(
        staged, _stage_run(kind, cuda, STAGE_SHAPES, "device"))
    n = 3 * len(STAGE_SHAPES)
    assert mid == (before[0] + n, before[1])
    assert (move_batch.staged, move_batch.direct) == (mid[0], mid[1] + n)


@pytest.mark.parametrize("kind", ["finetune", "pretrain"])
def test_staged_step_ignores_the_callers_later_writes(cuda, kind):
    """The caller overwrites its numpy arrays as soon as each step returns,
    before any synchronise, and the steps train as on untouched arrays."""
    _assert_same_training_state(
        _stage_run(kind, cuda, STAGE_SHAPES, "overwritten"),
        _stage_run(kind, cuda, STAGE_SHAPES, "device"))


def test_staging_ring_holds_two_steps_of_batches(cuda):
    """Six steps over three shapes in turn: after each, the ring's pinned
    bytes are those of the largest batch each slot has taken (at most two
    steps' worth), and the counters move by the arrays and bytes staged."""
    from vidsum_tpu_torch.train.steps import StagingRing, move_batch

    shapes = [(2, 128), (2, 256), (3, 256)] * 2

    def nbytes(B, N):   # x, target, mask
        return B * N * (STAGE_CFG.in_features * 4 + 4 + 1)

    staged, staged_bytes = move_batch.staged, move_batch.staged_bytes
    model, opt, step = _stage_setup("finetune", cuda, shapes[0][0])
    gen = torch.Generator().manual_seed(3)
    held = []
    for i, (B, N) in enumerate(shapes):
        step(model, opt, *_stage_batch("finetune", B, N, seed=i), gen)
        held.append(step.staging.held_bytes())
    torch.cuda.synchronize()
    want = []
    for i in range(len(shapes)):
        slots = [shapes[j] for j in range(i + 1)]
        want.append(sum(max(nbytes(*sh) for sh in slots[s::StagingRing.SLOTS])
                        for s in range(StagingRing.SLOTS)
                        if slots[s::StagingRing.SLOTS]))
    assert held == want
    assert max(held) <= StagingRing.SLOTS * max(nbytes(*sh) for sh in shapes)
    assert move_batch.staged == staged + 3 * len(shapes)
    assert move_batch.staged_bytes == staged_bytes + sum(
        nbytes(*sh) for sh in shapes)


def test_move_batch_passes_pinned_and_card_tensors_through(cuda):
    """A pinned host tensor is copied directly and a tensor on the card is
    itself; only the numpy array is staged."""
    from vidsum_tpu_torch.train.steps import StagingRing, move_batch

    x, y, mask = _stage_batch("finetune", 2, 128, seed=0)
    pinned = torch.from_numpy(x).pin_memory()
    on_card = torch.from_numpy(y).to(cuda)
    ring = StagingRing()
    before = move_batch.staged, move_batch.direct
    got = move_batch((pinned, on_card, mask), cuda, ring)
    torch.cuda.synchronize()
    assert got[1] is on_card
    assert torch.equal(got[0].cpu(), pinned)
    assert torch.equal(got[2].cpu(), torch.from_numpy(mask))
    assert (move_batch.staged, move_batch.direct) == (before[0] + 1,
                                                      before[1] + 2)
    assert ring.held_bytes() == mask.nbytes


@pytest.mark.parametrize("kind", ["finetune", "pretrain"])
def test_staged_step_copies_from_pinned_memory(cuda, kind, tmp_path):
    """Under ``utils.profiling.trace`` every host-to-device copy of the
    steps (set-up left out: the model's own move is pageable) reads pinned
    memory, none pageable."""
    import json

    _stage_run(kind, cuda, STAGE_SHAPES, "numpy", trace_dir=str(tmp_path))
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    h2d = [(e["name"], e.get("args", {}).get("bytes")) for e in events
           if e.get("name", "").startswith("Memcpy HtoD")]
    assert sum("Pinned" in n for n, _ in h2d) >= 3 * len(STAGE_SHAPES), h2d
    assert not [c for c in h2d if "Pageable" in c[0]], sorted(set(h2d))

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
@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128, 48, 80, 112, 160, 256,
                                320])
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


def _bf16_tensor_core_kernels_match_plain(cuda, folded, rate, B, H, N, Dh):
    """One bf16 training attention route's tensor-core kernels
    (``csrc/attention_train_mma.cuh``: the single pass, TPU kernels 5/6, or
    its online / folded mode, kernels 7/8) against their plain versions (the
    fold over the kernels' 64-key tiles) at the bf16 bounds (N = 320 leaves
    a ragged last CTA of 128 rows): element 0 has wholly padded key tiles
    (which the kernels skip); at B = 2 element 1 has no unpadded key, and
    there the kernels give what the FMA family gives (the f32 route on the
    same values: the single pass NaN o and grads and lse -inf, the fold
    o = 0, lse = -inf and zero grads, bit for bit). Two backward runs give
    equal bits; in the fold at rate 0.3 the kernels at seed + 1 fail the
    bounds. Prints the measured errors."""
    from vidsum_tpu_torch.ops import attention_train as at

    g = torch.Generator(device="cpu").manual_seed(13 if folded else 12)
    seed, scale, kb = (1357 if folded else 2468), Dh ** -0.5, at.KEY_TILE
    q, k, v, do = (torch.randn(B, H, N, Dh, generator=g).to(cuda,
                                                            torch.bfloat16)
                   for _ in range(4))
    mask = torch.zeros(B, N, dtype=torch.bool, device=cuda)
    mask[0, N * 5 // 8 - 20:] = True  # keys past tile 4 (of 8) all padded
    mask[1:] = True
    # the plain versions in 64-row steps (rows are independent; N = 320 is
    # no multiple of the TPU's 128)
    if folded:
        fwd, bwd = at._fwd_kernel_folded, at._bwd_kernel_folded

        def run_f(q, k, v, s):
            return fwd(q, k, v, mask, s, rate, scale, kb)

        def run_b(q, k, v, s, lse, do, o):
            return bwd(q, k, v, mask, s, lse, do, o, rate, scale, kb)

        def plain_f(s):
            return at.attention_train_fwd_folded_reference(
                q, k, v, mask, s, rate, scale, kb, rows=64)

        def plain_b(s, lse, o):
            return at.attention_train_bwd_folded_reference(
                q, k, v, mask, s, lse, do, o, rate, scale, kb, rows=64)
    else:
        fwd, bwd = at._fwd_kernel, at._bwd_kernel

        def run_f(q, k, v, s):
            return fwd(q, k, v, mask, s, rate, scale)

        def run_b(q, k, v, s, lse, do, o):
            return bwd(q, k, v, mask, s, lse, do, rate, scale)

        def plain_f(s):
            return at.attention_train_fwd_reference(q, k, v, mask, s, rate,
                                                    scale, rows=64)

        def plain_b(s, lse, o):
            return at.attention_train_bwd_reference(q, k, v, mask, s, lse,
                                                    do, rate, scale, rows=64)

    f0, b0 = fwd.launches, bwd.launches
    o, lse = run_f(q, k, v, seed)
    want_o, want_lse = plain_f(seed)
    grads = run_b(q, k, v, seed, want_lse, do, want_o)
    again = run_b(q, k, v, seed, want_lse, do, want_o)
    want = plain_b(seed, want_lse, want_o)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (f0 + 1, b0 + 2)
    # equal bits (NaN payloads included: the single pass's element 1)
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(grads, again))
    _close(o[:1], want_o[:1], "attention", torch.bfloat16)
    torch.testing.assert_close(lse[:1], want_lse[:1], rtol=1e-5, atol=1e-5)
    gtol = AT_TOL[("grad", torch.bfloat16)]
    errs = {"o": _rel(o[:1], want_o[:1])}
    for name, a, b in zip("qkv", grads, want):
        errs[f"d{name}"] = _rel(a[:1], b[:1])
        assert _at_within(a[:1], b[:1], gtol), f"d{name}: {errs[f'd{name}']}"
    print(f"bf16 tensor-core attention (folded={folded}) {(B, H, N, Dh)} "
          f"rate {rate}: relative RMS {errs}")
    if folded and rate > 0.0:
        bad_o, _ = run_f(q, k, v, seed + 1)
        assert not _within(bad_o, want_o, "attention", torch.bfloat16)
        bad = run_b(q, k, v, seed + 1, want_lse, do, want_o)
        assert not _at_within(bad[2], want[2], gtol)
    if B > 1:
        # the element with no unpadded key, against the FMA family (f32)
        f = [t.float() for t in (q, k, v, do)]
        o32, lse32 = run_f(*f[:3], seed)
        g32 = run_b(*f[:3], seed, lse32, f[3], o32)
        grads = run_b(q, k, v, seed, lse, do, o)
        torch.cuda.synchronize()
        assert torch.equal(lse[1], lse32[1]) and bool(
            torch.isneginf(lse[1]).all())
        if folded:
            assert torch.equal(o[1].float(), o32[1]) and not o32[1].any()
            for a, b in zip(grads, g32):
                assert torch.equal(a[1].float(), b[1]) and not b[1].any()
        else:
            assert torch.isnan(o[1]).all() and torch.isnan(o32[1]).all()
            for a, b in zip(grads, g32):
                assert torch.equal(torch.isnan(a[1]), torch.isnan(b[1]))


def _holes(B, N, dev):
    """(B, N) pad mask with whole 64-key tiles padded in the middle of
    element 0's row (keys 64-191) and at its end (the last tile), and in
    element 1 a first tile with exactly one unpadded key (key 5) and
    padded keys from N / 2 on (whole tiles at the end)."""
    m = torch.zeros(B, N, dtype=torch.bool)
    m[0, 64:192] = True
    m[0, N - 64:] = True
    m[1, :64] = True
    m[1, 5] = False
    m[1, N // 2:] = True
    for b in range(2, B):
        m[b, N * 3 // 4 + 1:] = True
    return m.to(dev)


def _block_attention_plain(qkv, mask, seed, H, scale, rate):
    """The training block's attention over the fused (B*N, 3d) QKV buffer
    in plain PyTorch (``block_reference_with_masks``'s, with the block's
    hash, site = head): (o as (B*N, d), lse as (B, H, N))."""
    from vidsum_tpu_torch.ops import block_train as bt

    B, N = mask.shape
    d = qkv.shape[1] // 3
    q, k, v = (qkv[:, i * d:(i + 1) * d].reshape(B, N, H, d // H)
               .transpose(1, 2) for i in range(3))
    s = torch.matmul(q, k.transpose(-1, -2)) * scale
    s = s.masked_fill(mask[:, None, None, :], float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    ar = lambda n: torch.arange(n, dtype=torch.int64,  # noqa: E731
                                device=qkv.device)
    keep = bt._keep_bits(seed, ar(H)[None, :, None, None],
                         ar(B)[:, None, None, None],
                         ar(N)[None, None, :, None],
                         ar(N)[None, None, None, :], rate)
    o = torch.matmul(bt._drop(torch.softmax(s, dim=-1), keep, rate), v)
    return o.transpose(1, 2).reshape(B * N, d), lse


# (B, H, N, Dh): every head_dim at small grids (8-deep thread tiles, a
# ragged last CTA), and at head_dim 64 a grid that takes the 16-deep tiles
# (128-row CTAs, ragged: N = 4,288) in every kernel
F32_HOLE_SHAPES = [(2, 2, 320, 16), (2, 2, 320, 32), (2, 2, 320, 64),
                   (2, 2, 320, 128), (2, 4, 4288, 64)]


@pytest.mark.parametrize("route", ["single", "single_d_pass", "folded",
                                   "block"])
@pytest.mark.parametrize("B,H,N,Dh", F32_HOLE_SHAPES)
def test_f32_attention_with_padded_key_tiles_matches_plain(cuda, route, B,
                                                           H, N, Dh):
    """The f32 FMA family (``csrc/attention_core.cuh``) on each route that
    launches it: the single pass (TPU kernels 5/6; its backward given the
    forward's o, as the Function gives it, or without o, summing D in a
    first pass), the fold (7/8) and the training block's attention (9-12,
    on the fused QKV buffer), with whole key tiles padded at the end and in
    the middle of a row and a tile with exactly one unpadded key: o, lse
    and dq/dk/dv within the f32 bounds of their plain versions; two
    backward runs give identical bits; seed + 1 and a dropped live key tile
    (the kernels given a mask that pads it) fail the bounds."""
    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops import block_train as bt

    g = torch.Generator(device="cpu").manual_seed(Dh + N)
    rate, seed, scale = 0.3, 97531, Dh ** -0.5
    mask = _holes(B, N, cuda)
    dropped = mask.clone()
    dropped[0, :64] = True  # a live tile, padded
    d = H * Dh
    if route == "block":
        qkv = torch.randn(B * N, 3 * d, generator=g).to(cuda)
        do = torch.randn(B * N, d, generator=g).to(cuda)
        dr = lambda s: bt._Drop(s, N, bt._threshold(rate),  # noqa: E731
                                bt._keep_scale(rate))

        def run_f(s, m=mask):
            m8 = m.to(torch.uint8).contiguous()
            return bt._attention_fwd(qkv, m8, B, H, N, scale, dr(s), True)

        def run_b(s, lse, o, m=mask):
            m8 = m.to(torch.uint8).contiguous()
            dqkv = bt._attention_bwd(qkv, o, do, lse, m8, B, H, N, scale,
                                     dr(s))
            return tuple(dqkv[:, i * d:(i + 1) * d] for i in range(3))

        with torch.enable_grad():
            qs = qkv.detach().requires_grad_()
            want_o, want_lse = _block_attention_plain(qs, mask, seed, H,
                                                      scale, rate)
            (dw,) = torch.autograd.grad(want_o, qs, do)
        want_o, want_lse = want_o.detach(), want_lse.detach()
        want = tuple(dw[:, i * d:(i + 1) * d] for i in range(3))
        counters = ()
    else:
        q, k, v, do = (torch.randn(B, H, N, Dh, generator=g).to(cuda)
                       for _ in range(4))
        kb = at.KEY_TILE
        if route == "folded":
            fwd, bwd = at._fwd_kernel_folded, at._bwd_kernel_folded

            def run_f(s, m=mask):
                return fwd(q, k, v, m, s, rate, scale, kb)

            def run_b(s, lse, o, m=mask):
                return bwd(q, k, v, m, s, lse, do, o, rate, scale, kb)

            want_o, want_lse = at.attention_train_fwd_folded_reference(
                q, k, v, mask, seed, rate, scale, kb, rows=N)
            want = at.attention_train_bwd_folded_reference(
                q, k, v, mask, seed, want_lse, do, want_o, rate, scale, kb,
                rows=N)
        else:
            fwd, bwd = at._fwd_kernel, at._bwd_kernel
            given_o = route == "single"

            def run_f(s, m=mask):
                return fwd(q, k, v, m, s, rate, scale)

            def run_b(s, lse, o, m=mask):
                return bwd(q, k, v, m, s, lse, do, rate, scale,
                           o=o if given_o else None)

            want_o, want_lse = at.attention_train_fwd_reference(
                q, k, v, mask, seed, rate, scale, rows=64)
            want = at.attention_train_bwd_reference(
                q, k, v, mask, seed, want_lse, do, rate, scale, rows=64)
        counters = (fwd, bwd)
    before = [c.launches for c in counters]
    passes = at._bwd_kernel.d_pass_launches
    o, lse = run_f(seed)
    grads = run_b(seed, want_lse, want_o)
    again = run_b(seed, want_lse, want_o)
    torch.cuda.synchronize()
    assert [c.launches for c in counters] == [n + k for n, k in
                                              zip(before, (1, 2))]
    assert at._bwd_kernel.d_pass_launches - passes == (
        2 if route == "single_d_pass" else 0)
    _close(o, want_o, "attention", torch.float32)
    torch.testing.assert_close(lse, want_lse, rtol=1e-5, atol=1e-5)
    gtol = AT_TOL[("grad", torch.float32)]
    for name, a, b in zip("qkv", grads, want):
        assert _at_within(a, b, gtol), f"d{name}: {_rel(a, b)}"
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    bad_o, _ = run_f(seed + 1)
    assert not _within(bad_o, want_o, "attention", torch.float32)
    bad = run_b(seed + 1, want_lse, want_o)
    assert not _at_within(bad[2], want[2], gtol)
    holed_o, _ = run_f(seed, dropped)
    assert not _within(holed_o, want_o, "attention", torch.float32)
    holed = run_b(seed, want_lse, want_o, dropped)
    assert not _at_within(holed[1], want[1], gtol)


def test_f32_attention_refuses_misaligned_operands(cuda):
    """A fused QKV view off its 16-byte boundary (or with another row
    stride) raises in the block's attention wrappers, and the kernels'
    entry points refuse a misaligned pointer themselves (no scalar
    fallback); the flash route copies its operands to aligned contiguous
    buffers, so any view it is given works."""
    from vidsum_tpu_torch.ops import _cuda
    from vidsum_tpu_torch.ops import attention_train as at
    from vidsum_tpu_torch.ops import block_train as bt

    B, H, N, Dh = 2, 4, 128, 16
    d = H * Dh
    dr = bt._Drop(7, N, bt._threshold(0.3), bt._keep_scale(0.3))
    mask8 = torch.zeros(B, N, dtype=torch.uint8, device=cuda)
    buf = torch.randn(B * N * 3 * d + 4, device=cuda)
    view = buf[1:1 + B * N * 3 * d].view(B * N, 3 * d)
    with pytest.raises(ValueError):
        bt._attention_fwd(view, mask8, B, H, N, 0.25, dr, keep=True)
    with pytest.raises(ValueError):
        bt._attention_bwd(view, torch.zeros(B * N, d, device=cuda),
                          torch.zeros(B * N, d, device=cuda),
                          torch.zeros(B, H, N, device=cuda), mask8, B, H, N,
                          0.25, dr)
    lib = _cuda.load("block_train")
    o = torch.empty(B * N, d, device=cuda)
    err = lib.vs_bt_attention_fwd(
        view.data_ptr(), mask8.data_ptr(), o.data_ptr(), None, B, H, N, Dh,
        0.25, 7, dr.thr, dr.kscale, _cuda.stream_of(o))
    assert err != 0
    q = torch.randn(1, 2, 256, 32, device=cuda)
    strided = torch.randn(1, 2, 256, 33, device=cuda)[..., 1:]
    mask = torch.zeros(1, 256, dtype=torch.bool, device=cuda)
    got, _ = at._fwd_kernel(q, strided, q, mask, 3, 0.0, 0.2)
    want, _ = at.attention_train_fwd_reference(q, strided, q, mask, 3, 0.0,
                                               0.2)
    _close(got, want, "attention", torch.float32)


TENSOR_CORE_SHAPES = [(2, 2, 512, 64), (1, 2, 256, 128), (2, 2, 320, 64)]


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,H,N,Dh", TENSOR_CORE_SHAPES)
def test_bf16_single_pass_tensor_core_kernels_match_plain(cuda, rate, B, H,
                                                          N, Dh):
    """The single pass's tensor-core kernels (TPU kernels 5/6); see
    ``_bf16_tensor_core_kernels_match_plain``."""
    _bf16_tensor_core_kernels_match_plain(cuda, False, rate, B, H, N, Dh)


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("B,H,N,Dh", TENSOR_CORE_SHAPES)
def test_bf16_folded_tensor_core_kernels_match_plain(cuda, rate, B, H, N,
                                                     Dh):
    """The fold's tensor-core kernels (TPU kernels 7/8); see
    ``_bf16_tensor_core_kernels_match_plain``."""
    _bf16_tensor_core_kernels_match_plain(cuda, True, rate, B, H, N, Dh)


def test_seq_forward_on_card_pads_shards_to_the_key_tile(cuda):
    """A seq-sharded forward at N = 8,320 on a (1, 4) mesh of one card
    (Nl 2,080, not a multiple of the ring kernels' 64-key tile, padded to
    2,112) takes kernel 15 and matches the plain ring's forward."""
    import importlib

    from vidsum_tpu_torch.parallel import make_mesh, make_seq_sharded_forward

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    cfg = ModelConfig(in_features=64, d_model=64, num_heads=4, num_layers=2)
    model = SimNet(cfg, device=cuda).eval()
    g = torch.Generator().manual_seed(6)
    N = 8320
    x = torch.randn(1, N, 64, generator=g).to(cuda)
    mask = torch.zeros(1, N, dtype=torch.bool, device=cuda)
    mask[:, 8100:] = True
    mesh = make_mesh((1, 4), "cuda:0")
    before = ra._ring_block_step.launches
    got_s, got_h = make_seq_sharded_forward(cfg, mesh)(model, x, mask)
    torch.cuda.synchronize()
    assert ra._ring_block_step.launches == before + 16 * cfg.num_layers
    want_s, want_h = make_seq_sharded_forward(cfg, mesh, block_impl="plain")(
        model, x, mask)
    assert got_s.shape == (1, N, 1) and got_h.shape == (1, N, 64)
    torch.testing.assert_close(got_s, want_s, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(got_h, want_h, atol=1e-4, rtol=1e-4)


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


@pytest.mark.parametrize("N", [256, 512])
def test_int8_residual_ln_epilogue_and_its_codes(cuda, N):
    """The LayerNorm moments are summed in another order than the plain
    version's: f32 outputs within summation-order error, and the row codes
    it emits for the next product equal the plain quantizer's codes of the
    kernel's own output; rows of 512 take the LayerNorm row kernel."""
    from vidsum_tpu_torch.ops import quant

    M, K = 200, 256
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


def _int8_epilogues(cuda, M, N, K, seed):
    """Operands on the card and the keyword arguments of each epilogue
    (residual + LayerNorm with the row codes; bf16 and f32 residuals)."""
    host = _int8_inputs(M, N, K, seed=seed)
    ops = tuple(t.to(cuda) for t in host)
    g = torch.Generator().manual_seed(seed)
    ln = dict(ln_g=(torch.rand(N, generator=g) + 0.5).to(cuda),
              ln_b=torch.randn(N, generator=g).to(cuda))
    res = torch.randn(M, N, generator=g)
    return ops, {
        "none": dict(out_dtype=torch.bfloat16, want_f32=True),
        "relu": dict(out_dtype=torch.float32),
        "residual_ln": dict(residual=res.to(cuda, torch.bfloat16),
                            out_dtype=torch.bfloat16, want_f32=True,
                            want_q=True, **ln),
        "residual_ln_f32": dict(residual=res.to(cuda), out_dtype=None,
                                want_f32=True, want_q=True, **ln)}


def _force_int8_tile(monkeypatch, tile):
    from vidsum_tpu_torch.ops import quant

    monkeypatch.setattr(quant, "int8_gemm_tile", lambda *a: tile)


@pytest.mark.parametrize("tile", [(128, 256), (128, 128), (64, 256),
                                  (64, 128)])
@pytest.mark.parametrize("M,N,K", [(200, 256, 32), (77, 512, 256),
                                   (300, 768, 1024), (130, 1024, 2048)])
def test_int8_wgmma_every_epilogue_matches_plain(cuda, monkeypatch, tile, M,
                                                 N, K):
    """The wgmma kernel in each CTA tile, ragged M (not a multiple of 64)
    and N 256-1,024, K 32 (one partial 128-deep stage) to 2,048 (16
    stages): the dequantised and ReLU products and the shift epilogue bit
    for bit against the plain version (exact s32 sums, the glue rounded as
    the tensor ops round it); residual + LayerNorm (bf16 and f32 residual;
    past 256 columns, or past a 128-column tile, through the row kernel)
    within summation-order error, its row codes equal to the plain
    quantizer's codes of the kernel's own output. One launch each, never
    the operand-staging fallback."""
    from vidsum_tpu_torch.ops import quant

    _force_int8_tile(monkeypatch, tile)
    (x8, sx, w8, sw, b), cases = _int8_epilogues(cuda, M, N, K, seed=M + K)
    fn = quant.int8_gemm
    before = (fn.launches, fn.fallback_launches)
    for name, kw in cases.items():
        epi = "residual_ln" if name.startswith("residual_ln") else name
        got = fn(x8, sx, w8, sw, b, epi, **kw)
        want = quant.int8_gemm_reference(x8, sx, w8, sw, b, epi, **kw)
        if epi != "residual_ln":
            for g_, w_ in zip(got, want):
                assert (g_ is None) == (w_ is None)
                if g_ is not None:
                    assert torch.equal(g_, w_), name
            continue
        torch.testing.assert_close(got[1], want[1], atol=1e-5, rtol=1e-5)
        if got[0] is not None:
            assert torch.equal(got[0], got[1].to(got[0].dtype))
        wq, ws = quant.quantize_rows_reference(got[1])
        assert torch.equal(got[2], wq) and torch.equal(got[3], ws[:, 0])
    shifted = fn(x8, None, w8, None, None, "shift")
    assert torch.equal(shifted, quant.int8_gemm_reference(
        x8, None, w8, None, None, "shift"))
    torch.cuda.synchronize()
    assert (fn.launches, fn.fallback_launches) == (before[0] + 5, before[1])


def test_int8_wgmma_tiles_and_batches_give_the_same_bits(cuda, monkeypatch):
    """Every output, LayerNorm rows and their codes included, is the same
    bits in 64- and 128-row CTAs, at 256 columns (the row in one tile) and
    at 128 (a 256-column row then goes through the row kernel); the other
    epilogues are the same bits in all four tiles. A request's rows alone
    equal the same rows in a batch of 2,125 (served scores equal solo
    scores)."""
    from vidsum_tpu_torch.ops import quant

    M, N, K = 2125, 256, 256
    (x8, sx, w8, sw, b), cases = _int8_epilogues(cuda, M, N, K, seed=7)
    runs = {}
    for tile in ((128, 256), (128, 128), (64, 256), (64, 128)):
        _force_int8_tile(monkeypatch, tile)
        for name, kw in cases.items():
            epi = "residual_ln" if name.startswith("residual_ln") else name
            runs.setdefault(name, []).append(
                quant.int8_gemm(x8, sx, w8, sw, b, epi, **kw))
    monkeypatch.undo()
    for name, outs in runs.items():
        # tiles (128, 256), (128, 128), (64, 256), (64, 128)
        pairs = ((0, 2), (1, 3)) if name.startswith("residual_ln") else \
            ((0, 1), (0, 2), (0, 3))
        for i, j in pairs:
            for a, c in zip(outs[i], outs[j]):
                assert (a is None and c is None) or torch.equal(a, c), name
    rows = slice(300, 812)
    for name, kw in cases.items():
        epi = "residual_ln" if name.startswith("residual_ln") else name
        sub = {k: (v[rows] if k == "residual" else v) for k, v in kw.items()}
        alone = quant.int8_gemm(x8[rows], sx[rows], w8, sw, b, epi, **sub)
        for a, c in zip(alone, runs[name][0]):
            assert (a is None and c is None) or torch.equal(a, c[rows]), name


def test_int8_gemm_misaligned_base_is_staged(cuda):
    """An operand off a 16-byte boundary (TMA reads from one) is copied
    onto one first: the same kernel, the same bits, counted in
    ``int8_gemm.fallback_launches``."""
    from vidsum_tpu_torch.ops import quant

    (x8, sx, w8, sw, b), _ = _int8_epilogues(cuda, 96, 256, 64, seed=9)
    buf = torch.empty(96 * 64 + 1, dtype=torch.int8, device=cuda)
    off = buf[1:].view(96, 64)
    off.copy_(x8)
    assert off.data_ptr() % 16 != 0
    fn = quant.int8_gemm
    before = (fn.launches, fn.fallback_launches)
    got = fn(off, sx, w8, sw, b, "relu", want_f32=True)[1]
    torch.cuda.synchronize()
    assert (fn.launches, fn.fallback_launches) == (before[0] + 1,
                                                   before[1] + 1)
    assert torch.equal(got, fn(x8, sx, w8, sw, b, "relu",
                               want_f32=True)[1])
    assert fn.fallback_launches == before[1] + 1


# the chip-smoke bound of the int8 block (tests/test_quant.py's limits)
INT8_BOUND = dict(median=5e-3, max=5e-2)


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,B,N,route", [
    (256, 2, 256, "_fused_block_int8_grouped"),
    (256, 1, 512, "_fused_block_int8"),
    (64, 2, 128, "_fused_block_int8_grouped"),
    (384, 2, 256, "_fused_block_int8_grouped"),
    (512, 2, 256, "_fused_block_int8_grouped"),
    (512, 1, 512, "_fused_block_int8")])
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


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,heads,B,N,route", [
    (640, 4, 2, 256, "_fused_block_int8_grouped"),
    (1056, 8, 1, 512, "_fused_block_int8"),
    (200, 4, 2, 256, "_fused_block_int8_grouped")])
def test_int8_block_routes_match_plain_at_wide_shapes(cuda, qk_int8, dtype,
                                                      d, heads, B, N, route):
    """Each int8 route, past the copied TPU envelope, at head_dim 160 (two
    128-column slices; with ``qk_int8`` the int8 scores summed over the
    slices in s32 and scaled once with the whole head's row scales), at d
    1,056 (LayerNorm rows past 1,024 columns, head_dim 132) and at d 200
    (off the 32-column grid: the int8 GEMM's K zero-padded to 224) against
    its plain version at the int8 block bound."""
    from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
    from vidsum_tpu_torch.ops.quant import quantize_block

    cfg = ModelConfig(d_model=d, num_heads=heads, num_layers=1)
    block = SimNet(cfg, device=cuda,
                   generator=torch.Generator().manual_seed(d + N)
                   ).encoder.module_list[0]
    qb = quantize_block(block)
    x = torch.randn(B, N, d, generator=torch.Generator().manual_seed(N))
    x = x.to(cuda, dtype)
    mask = _mask(B, N, cuda, seed=N)
    fn = getattr(bk8, route)
    before = fn.launches
    got = fn(qb, x, mask, heads, cfg.attn_scale, qk_int8)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = bk8.int8_block_reference(qb, x, mask, heads, cfg.attn_scale,
                                    qk_int8)
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


# ------------------------------------- ring attention (TPU kernels 15-17)

def _ring_inputs(dev, B=2, H=2, Nl=256, Dh=64, seed=0):
    g = torch.Generator().manual_seed(seed)
    q32, k, v, go = (torch.randn(B, H, Nl, Dh, generator=g).to(dev)
                     for _ in range(4))
    mask = torch.zeros(B, Nl, dtype=torch.bool)
    mask[0, 200:] = True
    mask[1] = True  # a fully padded block
    return q32 * 0.125, k, v, go, mask.to(dev)


def _ring_carry(ra, q32, k, v, mask):
    """A carry one plain fold left (row 1's keys all padded: m -inf)."""
    return ra.ring_block_step_reference(q32, k.roll(1, 2), v.roll(1, 2),
                                        mask, *ra._init_carries(q32))


def _ring_carries_close(got, want):
    o, m, l = got
    wo, wm, wl = want
    assert torch.equal(torch.isneginf(m), torch.isneginf(wm))
    live = ~torch.isneginf(wm)
    torch.testing.assert_close(m[live], wm[live], atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(l, wl, atol=1e-5, rtol=1e-5)
    scale = float(wo.abs().max())
    torch.testing.assert_close(o, wo, atol=1e-5 * scale, rtol=1e-5)


@pytest.mark.parametrize("kv_dtype", DTYPES)
@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128, 48, 80, 160, 256])
def test_ring_block_step_matches_plain(cuda, kv_dtype, Dh):
    import importlib

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    q32, k, v, _, mask = _ring_inputs(cuda, Dh=Dh)
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    carry = _ring_carry(ra, q32, k, v, mask)
    before = ra._ring_block_step.launches
    got = ra._ring_block_step(q32, k, v, mask, *carry)
    torch.cuda.synchronize()
    assert ra._ring_block_step.launches == before + 1
    want = ra.ring_block_step_reference(q32, k, v, mask, *carry)
    _ring_carries_close(got, want)
    # a block whose keys are all padded leaves the carry bit for bit (row
    # 1's m = -inf and l = 0 included)
    padded = torch.ones_like(mask)
    kept = ra._ring_block_step(q32, k, v, padded, *carry)
    assert all(torch.equal(a, b) for a, b in zip(kept, carry))


@pytest.mark.parametrize("rate", [0.0, 0.3])
@pytest.mark.parametrize("Dh", [64, 96, 128, 80, 112, 160, 320])
def test_ring_train_steps_match_plain(cuda, rate, Dh):
    import importlib

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    q32, k, v, go, mask = _ring_inputs(cuda, Dh=Dh, seed=1)
    info = (4321, 2, 512, 256)
    carry = _ring_carry(ra, q32, k, v, mask)
    got = ra._ring_train_step(q32, k, v, mask, info, *carry, rate)
    want = ra.ring_train_step_reference(q32, k, v, mask, info, *carry, rate)
    _ring_carries_close(got, want)
    o, m, l = want
    d = (go * torch.randn_like(o)).sum(-1, keepdim=True)
    acc = tuple(torch.randn_like(t) for t in (q32, k, v))
    args = (q32, k, v, go, d, m, l, mask, info, *acc, rate)
    grads = ra._ring_train_step_bwd(*args)
    again = ra._ring_train_step_bwd(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    ref = ra.ring_train_step_bwd_reference(*args)
    for a, b in zip(grads, ref):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=1e-4)
    if rate:
        # the planted fault: k0 of the neighbouring shard moves the bits
        bad = ra._ring_train_step(q32, k, v, mask, info[:3] + (512,), *carry,
                                  rate)
        assert not torch.allclose(bad[0], want[0], atol=1e-3, rtol=1e-3)


@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128, 48, 256])
def test_ring_kernels_pass_an_all_padded_block_through(cuda, Dh):
    """Kernels 15-17 on a block whose keys are all padded walk no key tile:
    the carry, and dq, dk, dv, come out as they went in, bit for bit (rows
    with m = -inf and l = 0 included), as from the plain steps."""
    import importlib

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    q32, k, v, go, mask = _ring_inputs(cuda, Dh=Dh, seed=5)
    carry = _ring_carry(ra, q32, k, v, mask)
    padded = torch.ones_like(mask)
    info = (2024, 1, 256, 512)
    kept = ra._ring_block_step(q32, k.bfloat16(), v.bfloat16(), padded,
                               *carry)
    assert all(torch.equal(a, b) for a, b in zip(kept, carry))
    kept = ra._ring_train_step(q32, k, v, padded, info, *carry, 0.3)
    assert all(torch.equal(a, b) for a, b in zip(kept, carry))
    o, m, l = ra.ring_train_step_reference(q32, k, v, mask, info, *carry,
                                           0.3)
    d = (go * ra._normalize(o, l, torch.float32)).sum(-1, keepdim=True)
    acc = tuple(torch.randn_like(t) for t in (q32, k, v))
    before = ra._ring_train_step_bwd.launches
    grads = ra._ring_train_step_bwd(q32, k, v, go, d, m, l, padded, info,
                                    *acc, 0.3)
    torch.cuda.synchronize()
    assert ra._ring_train_step_bwd.launches == before + 1
    assert all(torch.equal(a, b) for a, b in zip(grads, acc))


@pytest.mark.parametrize("Dh", [16, 32, 64, 96, 128, 48, 256])
def test_ring_kernels_bits_do_not_depend_on_the_cta_shape(cuda, monkeypatch,
                                                          Dh):
    """Every CTA shape of every ring kernel (128- and 64-row at head_dim
    <= 64; one shape past it) gives the same bits (Nl 320: the 128-row
    CTAs end ragged), and the kernels hold their plain steps in each."""
    import importlib

    from vidsum_tpu_torch.ops import _cuda

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    q32, k, v, go, mask = _ring_inputs(cuda, Nl=320, Dh=Dh, seed=6)
    mask[0, 150:] = True  # whole padded key tiles at the end of row 0
    info = (31, 0, 320, 0)
    carry = _ring_carry(ra, q32, k, v, mask)
    o, m, l = ra.ring_train_step_reference(q32, k, v, mask, info, *carry,
                                           0.3)
    d = (go * ra._normalize(o, l, torch.float32)).sum(-1, keepdim=True)
    acc = tuple(torch.randn_like(t) for t in (q32, k, v))
    bargs = (q32, k, v, go, d, m, l, mask, info, *acc, 0.3)
    Dp = _cuda.kernel_head_dim(Dh, "ring")
    results = []
    for i in range(max(len(ra.ring_shapes(kk, Dp)) for kk in ra.RING_KERNELS)):
        # the i-th shape of each kernel (its last where it has fewer)
        monkeypatch.setattr(
            ra, "ring_cta_shape",
            lambda kernel, *a, i=i: ra.ring_shapes(kernel, Dp)[
                min(i, len(ra.ring_shapes(kernel, Dp)) - 1)])
        fwd15 = ra._ring_block_step(q32, k.bfloat16(), v.bfloat16(), mask,
                                    *carry)
        fwd16 = ra._ring_train_step(q32, k, v, mask, info, *carry, 0.3)
        _ring_carries_close(fwd16, (o, m, l))
        grads = ra._ring_train_step_bwd(*bargs)
        for a, b in zip(grads, ra.ring_train_step_bwd_reference(*bargs)):
            torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                       rtol=1e-4)
        results.append((*fwd15, *fwd16, *grads))
    torch.cuda.synchronize()
    for other in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(results[0], other))


def test_ring_cta_shapes_on_the_card(cuda):
    """The card's occupancy report gives every shape of the ring kernels at
    least one CTA an SM, the wrappers' picks are shapes the kernels have,
    and a shape they do not have is refused."""
    import ctypes
    import importlib

    from vidsum_tpu_torch.ops import _cuda

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    lib = _cuda.load("ring_attention")
    for kernel in ra.RING_KERNELS:
        for Dh in _cuda.HEAD_DIMS:
            for ty, ri in ra.ring_shapes(kernel, Dh):
                assert ra._card_slots(kernel, Dh, 2048)(ty, ri) >= 1
            assert ra._shape(kernel, 4, 4, 2048, 2048, Dh, cuda) in \
                ra.ring_shapes(kernel, Dh)
    out = ctypes.c_int(0)
    assert lib.vs_ring_slots(2, 128, 16, 4, 2048, ctypes.byref(out)) != 0
    q32, k, v, _, mask = _ring_inputs(cuda, Dh=128, seed=7)
    carry = _ring_carry(ra, q32, k, v, mask)
    o_out, m_out, l_out = (torch.empty_like(t) for t in carry)
    mask8 = mask.to(torch.uint8)
    err = lib.vs_ring_fwd(
        *(_cuda.ptr(t) for t in (q32, k, v, mask8, *carry, o_out, m_out,
                                  l_out)),
        2, 2, 256, 256, 128, 12, 0, 0, 0, 0, 0, 0, 1.0,
        _cuda.stream_of(q32))
    assert err != 0  # depth 12


def test_ring_forward_on_one_card_mesh(cuda):
    """make_ring_forward on a 4-entry mesh of one card launches kernel 15
    P x P times and matches the plain ring and dense attention."""
    import importlib

    from vidsum_tpu_torch.parallel.mesh import make_mesh

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    g = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn(2, 4, 1024, 64, generator=g).to(cuda)
               for _ in range(3))
    mask = torch.zeros(2, 1024, dtype=torch.bool, device=cuda)
    mask[:, 700:] = True  # the last shard entirely padding
    mesh = make_mesh((1, 4), "cuda:0")
    before = ra._ring_block_step.launches
    got = ra.make_ring_forward(mesh, 0.125)(q, k, v, mask)
    torch.cuda.synchronize()
    assert ra._ring_block_step.launches == before + 16
    want = ra.make_ring_forward(mesh, 0.125, block_impl="plain")(
        q, k, v, mask)
    _close(got, want, "attention", torch.float32)
    _close(got, attn_mod.attention_reference(q, k, v, mask, 0.125),
           "attention", torch.float32)


def test_ring_past_the_tpu_envelope_takes_the_kernels(cuda):
    """On the card ``"auto"`` takes kernels 15-17 at lengths past the TPU
    kernels' VMEM envelope (Nl 7,040 > 6,912 forward, 3,072 > 2,944 in
    training), where the JAX package would take its XLA step, and matches
    the plain rings there; a head_dim past the kernels' 128 raises (one
    below it runs zero-padded)."""
    import importlib

    ra = importlib.import_module("vidsum_tpu_torch.parallel.ring_attention")
    g = torch.Generator().manual_seed(4)
    P = 4

    def split(t, d=2):
        return list(torch.chunk(t, P, dim=d))

    N = 7040 * P
    assert not ra._ring_block_supported(N // P, N // P, 64, 4)
    q, k, v = (torch.randn(1, 1, N, 64, generator=g).to(cuda)
               for _ in range(3))
    mask = torch.zeros(1, N, dtype=torch.bool, device=cuda)
    mask[:, N - 1000:] = True
    before = ra._ring_block_step.launches
    got = ra.ring_attention(split(q), split(k), split(v), split(mask, 1),
                            0.125)
    torch.cuda.synchronize()
    assert ra._ring_block_step.launches == before + P * P
    want = ra.ring_attention(split(q), split(k), split(v), split(mask, 1),
                             0.125, block_impl="plain")
    _close(torch.cat(got, 2), torch.cat(want, 2), "attention", torch.float32)

    N = 3072 * P
    assert not ra._ring_train_supported(N // P, N // P, 64)
    q, k, v, w = (torch.randn(1, 1, N, 64, generator=g).to(cuda)
                  for _ in range(4))
    mask = torch.zeros(1, N, dtype=torch.bool, device=cuda)
    mask[:, N - 1000:] = True
    counts = (ra._ring_train_step.launches, ra._ring_train_step_bwd.launches)
    results = []
    for impl in ("auto", "plain"):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = torch.cat(ra.ring_attention_train(
            *(split(t) for t in leaves), split(mask, 1), 0.125, 77, 0.3,
            block_impl=impl), 2)
        (out * w).sum().backward()
        results.append((out.detach(), *(t.grad for t in leaves)))
    torch.cuda.synchronize()
    assert (ra._ring_train_step.launches - counts[0],
            ra._ring_train_step_bwd.launches - counts[1]) == (P * P, P * P)
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()),
                                   rtol=1e-4)

    q32 = torch.randn(1, 1, 256, 160, generator=g).to(cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ra.ring_attention(split(q32), split(q32), split(q32), None, 0.1)


def _fold_items(n_videos, in_features, seed):
    """In-memory finetune items in the DSNet schema (the fold loop's
    ``fold_datasets`` reads h5 files; the card's machine has no h5py)."""
    from vidsum_tpu_torch.data.datasets import UserSummaries

    rng = np.random.default_rng(seed)
    items = {}
    for vi in range(n_videos):
        n = int(rng.integers(60, 300))
        picks = np.arange(n) * 15
        n_frames = int(picks[-1] + 8)
        feats = rng.normal(size=(n, in_features)).astype(np.float32)
        gt = rng.random(n).astype(np.float32)
        cuts = np.sort(rng.choice(np.arange(1, n_frames), 5, replace=False))
        bounds = np.concatenate([[0], cuts, [n_frames]])
        cps = np.stack([bounds[:-1], bounds[1:] - 1], axis=1)
        users = (rng.random((3, n_frames)) < 0.15).astype(np.int8)
        items[f"video_{vi}"] = (feats, gt, UserSummaries(
            user_summary=users, user_scores=rng.random((3, n_frames)),
            change_points=cps, n_frames=n_frames, picks=picks,
            name=f"video_{vi}"))
    return items


def test_finetune_resume_and_ckpt_service_on_the_card(cuda, monkeypatch,
                                                      tmp_path):
    """``finetune()`` on the card (the training block kernels, the f32
    serving chain in the val pass): two epochs and a resume to three give
    the bits of three straight epochs in model_mae.ckpt; ``cli.serve``'s
    ``load_model`` on that file serves the trained model's scores bit for
    bit."""
    from vidsum_tpu_torch.cli import serve as serve_cli
    from vidsum_tpu_torch.config import Config, TrainConfig
    from vidsum_tpu_torch.ops import block_train as bt
    from vidsum_tpu_torch.serve import ScoringService
    from vidsum_tpu_torch.train import checkpoint as ck
    from vidsum_tpu_torch.train import finetune as ft

    cfg = ModelConfig(in_features=64, d_model=64, num_heads=2, num_layers=2,
                      dropout=0.3)
    items = _fold_items(10, cfg.in_features, 5)
    split = {"train_keys": [f"x.h5/video_{i}" for i in range(8)],
             "test_keys": ["x.h5/video_8", "x.h5/video_9"]}
    monkeypatch.setattr(ft, "fold_datasets", lambda c, s: (
        [items[k.split("/")[-1]][:2] for k in s["train_keys"]],
        [items[k.split("/")[-1]] for k in s["test_keys"]]))
    models = []
    real = ft.make_optimizer

    def recording(model, *args):
        models.append(model)
        return real(model, *args)

    monkeypatch.setattr(ft, "make_optimizer", recording)

    def conf(epochs):
        return Config(model=cfg, train=TrainConfig(batch_size=4,
                                                   max_epoch=epochs))

    bt._fwd_kernel_grouped.launches = 0
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    ft.finetune(conf(3), [split], workdir=a, export_summary=False)
    ft.finetune(conf(2), [split], workdir=b, export_summary=False)
    ft.finetune(conf(3), [split], workdir=b, export_summary=False,
                resume=True)
    assert bt._fwd_kernel_grouped.launches > 0
    sa, _ = ck.load_checkpoint(f"{a}/model_mae.ckpt")
    sb, _ = ck.load_checkpoint(f"{b}/model_mae.ckpt")
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k

    args = serve_cli.build_parser().parse_args(["--ckpt",
                                                f"{a}/model_mae.ckpt"])
    loaded = serve_cli.load_model(args, cfg)
    feats = [items["video_8"][0], items["video_9"][0]]
    scores = []
    for m in (models[0], loaded):
        with ScoringService(m, cfg, max_delay_ms=0.0) as svc:
            scores.append([svc.submit(f).result(timeout=120).scores
                           for f in feats])
    for x, y in zip(*scores):
        np.testing.assert_array_equal(x, y)


def test_supervised_recycle_on_the_card(cuda, tmp_path):
    """``cli.serve --recycle_after_requests 4`` as a supervisor spawning
    workers on the card: 12 requests paced 0.6 s apart (past the workers'
    0.5 s monitor poll) all succeed across at least two recycles, no worker
    crashes, and SIGINT ends the supervisor with 0."""
    import io
    import json
    import os
    import signal
    import socket
    import subprocess
    import sys
    import time
    import urllib.error
    import urllib.request

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "vidsum_tpu_torch.cli.serve", "--host",
           "127.0.0.1", "--port", str(port), "--max_delay_ms", "0",
           "--warmup", "", "--recycle_after_requests", "4"]
    log_path = tmp_path / "serve.log"
    with open(log_path, "w") as log:
        proc = subprocess.Popen(cmd, cwd=repo, stdout=log,
                                stderr=subprocess.STDOUT)
    feats = np.random.default_rng(2).normal(size=(200, 1024)).astype(
        np.float32)
    buf = io.BytesIO()
    np.savez(buf, features=feats)
    try:
        deadline = time.monotonic() + 300
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=10):
                    break
            except (urllib.error.URLError, OSError):
                assert time.monotonic() < deadline, log_path.read_text()
                time.sleep(1.0)
        for _ in range(12):
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/summarize?summary=0",
                data=buf.getvalue(), method="POST")
            with urllib.request.urlopen(req, timeout=300) as resp:
                assert len(json.loads(resp.read())["scores"]) == 200
            time.sleep(0.6)
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            proc.wait(timeout=180)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    log = log_path.read_text()
    assert proc.returncode == 0, log[-3000:]
    assert log.count("recycled after") >= 2, log[-3000:]
    assert "died rc=" not in log, log[-3000:]
