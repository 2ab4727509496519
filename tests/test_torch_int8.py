"""The port's int8 scoring path (ops/quant.py, ops/block_kernel_int8.py, the
SimNet int8 routes, the int8 serving wire and the int8 probe of
tools/probe_int8_mma.py) against the JAX package, on the CPU.

The quantizers, ``int8_linear``, ``quantize_frames`` and the probe's int8
product are bit-equal to the JAX package. The int8 blocks and the whole int8
route agree within the JAX tests' own bounds (tests/test_quant.py: median
5e-3, max 5e-2; one int8 code flipped by f32 glue rounded elsewhere moves
its row by about one quantisation step). Measured on these inputs, f32: the
port's plain versions against ``int8_encoder_block_xla`` and against the
Pallas kernels in interpret mode, median 3e-8 and max 7.2e-7 with
``qk_int8`` off, max 1.1e-3 to 4.6e-3 with it on (a per-head code flipped);
bf16, median 0 and max 1.6e-2 (one bf16 step at outputs up to 4); the whole
route, scores max 5.3e-5 (2.5e-3 with ``qk_int8``), hidden max 3.3e-3
(8.3e-3). Where the JAX side reaches Pallas it runs in interpret mode
inside one ``jax.jit``, as tests/test_quant.py runs it."""

import importlib.util
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet, simnet_apply
from vidsum_tpu.ops import block_kernel_int8 as jax_bk8
from vidsum_tpu.ops import quant as jax_quant
from vidsum_tpu.serve import transport as jax_transport
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.data.collate import bucket_length
from vidsum_tpu_torch.models import simnet as simnet_mod
from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import block_kernel_int8 as bk8
from vidsum_tpu_torch.ops import quant
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.serve import transport
from vidsum_tpu_torch.tools import probe_int8_mma as probe
from vidsum_tpu_torch.train.steps import make_eval_forward

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(in_features=48, d_model=64, num_heads=2, num_layers=2,
          max_len=256)
D, H = KW["d_model"], KW["num_heads"]
SCALE = D ** -0.5
BOUND = dict(median=5e-3, max=5e-2)   # tests/test_quant.py:94-107


def _pair(seed=0, **extra):
    jcfg = JaxModelConfig(dropout=0.0, **{**KW, **extra})
    params = init_simnet(jax.random.PRNGKey(seed), jcfg)
    cfg = ModelConfig(**{**KW, **extra})
    model = SimNet(cfg, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return jcfg, params, cfg, model.eval()


def _rows():
    """Rows with zeros, exact .5 boundaries (absmax 127 gives scale 1, so
    x * (1/scale) lands on k + 0.5), negatives and wide ranges."""
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(24, 96)) * 10.0).astype(np.float32)
    x[3] = 0.0
    x[5, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5, -126.5]
    x[5, 8:] = 0.0
    x[7] *= 1e-3
    x[9, 0] = -1e4
    return x


def _close(got, want, what=""):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    assert float(np.median(d)) < BOUND["median"], (what, float(np.median(d)))
    assert float(d.max()) < BOUND["max"], (what, float(d.max()))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_is_bit_equal(dtype):
    x = _rows()
    jq, js = jax_quant.quantize_rows(jnp.asarray(x, dtype))
    tq, ts = quant.quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == (24, 1)
    np.testing.assert_array_equal(tq.numpy()[5, :6], [127, 0, 2, 2, 0, -2])


def test_quantize_weight_is_the_jax_codes_transposed():
    w = _rows().T.copy()          # JAX layout (K=96, M=24); column 3 zero
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    tq, ts = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float(ts[3]) == 1.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_int8_linear_is_bit_equal(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 33, 96)).astype(np.float32)
    x[1, 4] = 0.0
    w = rng.normal(size=(96, 40)).astype(np.float32)
    b = rng.normal(size=(40,)).astype(np.float32)
    jq, js = jax_quant.quantize_weight(jnp.asarray(w))
    want = jax_quant.int8_linear(jnp.asarray(x, dtype), jq, js, jnp.asarray(b))
    tq, ts = quant.quantize_weight(torch.from_numpy(w.T.copy()))
    got = quant.int8_linear(torch.from_numpy(x).to(getattr(torch, dtype)),
                            tq, ts, torch.from_numpy(b))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_frames_and_int8_rows_are_bit_equal():
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(100, 48)).astype(np.float32)
    feats[7] = 0.0
    feats[8, :3] = [127.0, 0.5, -2.5]
    feats[8, 3:] = 0.0
    jq, js = jax_transport.quantize_frames(feats)
    tq, ts = transport.quantize_frames(feats)
    np.testing.assert_array_equal(tq, jq)
    np.testing.assert_array_equal(ts, js)
    # a served row: built in f32, padded with pad_value, then quantised
    jwire = jax_transport.Wire(dtype=np.dtype(np.int8), coalesced=False,
                               int8=True, fwd=None)
    want = jax_transport.build_short_row(jwire, feats, 128, 48, 1000.0)
    wire = transport.resolve_wire(ModelConfig(**KW), "int8", "rows",
                                  torch.device("cpu"), None)
    got = transport.build_short_row(wire, feats, 128, 48, 1000.0)
    np.testing.assert_array_equal(got[0].numpy(), want[0])
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    assert float(got[1][-1]) == np.float32(1000.0 / 127.0)


def test_fused_block_int8_supported_matches_jax():
    for B in (1, 2, 3, 4, 8, 32):
        for N in (128, 130, 256, 384, 512, 1280, 2048, 4096, 6016, 8192):
            for d in (64, 256):
                for itm in (2, 4):
                    assert (bk8.fused_block_int8_supported(B, N, d, itm)
                            == jax_bk8.fused_block_int8_supported(
                                B, N, d, itm)), (B, N, d, itm)


def _jax_blocks(params, x, mask, qk_int8):
    """int8_encoder_block_xla and the Pallas kernel (interpret) on the
    first block, in one jit."""
    qb = jax_quant.quantize_block(params["blocks"][0])

    @jax.jit
    def run(qb, x, mask):
        return (jax_quant.int8_encoder_block_xla(qb, x, mask, H, SCALE,
                                                 qk_int8=qk_int8),
                jax_bk8.fused_encoder_block_int8(qb, x, mask, H, SCALE,
                                                 qk_int8=qk_int8))

    return qb, [np.asarray(a) for a in run(qb, jnp.asarray(x),
                                           jnp.asarray(mask))]


@pytest.mark.parametrize("qk_int8", [False, True])
@pytest.mark.parametrize("B,N", [(2, 256), (8, 128), (3, 512)])
def test_int8_blocks_match_jax(B, N, qk_int8):
    """(2, 256) and (8, 128) take the grouped kernel (14), (3, 512) the
    per-element one (13); the port's dense route and its kernels' plain
    version against the JAX dense block and the Pallas kernel."""
    _, params, _, model = _pair(seed=B * N)
    rng = np.random.default_rng(N)
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mask = np.arange(N)[None] >= rng.integers(N // 2, N + 1, size=B)[:, None]
    jqb, (want_dense, want_kernel) = _jax_blocks(params, x, mask, qk_int8)
    qb = quant.quantize_block(model.encoder.module_list[0])
    np.testing.assert_array_equal(
        qb.wqkv.numpy(), np.concatenate([np.asarray(jqb["attn"][n]["wq"]).T
                                         for n in "qkv"]))
    np.testing.assert_array_equal(qb.s1.numpy(),
                                  np.asarray(jqb["mlp"]["fc1"]["sw"]))
    assert bk8._pick_group(B, N) == jax_bk8._pick_group(B, N)
    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    dense = quant.int8_encoder_block_dense(qb, xt, mt, H, SCALE,
                                           qk_int8=qk_int8)
    kernel = bk8.fused_encoder_block_int8(qb, xt, mt, H, SCALE,
                                          qk_int8=qk_int8)
    _close(dense.numpy(), want_dense, "dense")
    _close(kernel.numpy(), want_kernel, "kernel plain version")


def test_int8_block_bf16_matches_jax():
    _, params, _, model = _pair(seed=5)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 256, D)).astype(np.float32)
    mask = np.zeros((2, 256), bool)
    mask[1, 190:] = True
    qb = jax_quant.quantize_block(params["blocks"][0])
    want = jax.jit(lambda q, x, m: jax_bk8.fused_encoder_block_int8(
        q, x, m, H, SCALE, qk_int8=False))(
        qb, jnp.asarray(x, jnp.bfloat16), jnp.asarray(mask))
    got = bk8.fused_encoder_block_int8(
        quant.quantize_block(model.encoder.module_list[0]),
        torch.from_numpy(x).bfloat16(), torch.from_numpy(mask), H, SCALE,
        qk_int8=False)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), np.asarray(want, np.float32), "bf16")


def test_fused_block_int8_raises_past_the_envelope():
    qb = quant.quantize_block(_pair()[3].encoder.module_list[0])
    with pytest.raises(ValueError, match="multiple of"):
        bk8.fused_encoder_block_int8(qb, torch.zeros(1, 130, D), None, H,
                                     SCALE, tile_q=128)
    with pytest.raises(ValueError, match="exceeds VMEM"):
        bk8.fused_encoder_block_int8(qb, torch.zeros(1, 16384, D), None, H,
                                     SCALE)


@pytest.mark.parametrize("qk_int8", [False, True])
def test_int8_route_matches_simnet_apply(qk_int8, monkeypatch):
    """The whole "int8_block" route (int8 embed, two grouped-kernel blocks,
    head) against ``simnet_apply(attn_impl="int8_block")``."""
    monkeypatch.setenv("VIDSUM_TPU_INT8_QK", "1" if qk_int8 else "0")
    jcfg, params, _, model = _pair(seed=7)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 256, KW["in_features"])).astype(np.float32)
    mask = np.zeros((2, 256), bool)
    mask[1, 170:] = True
    x[1, 170:] = 1000.0
    jax.clear_caches()
    try:
        s_j, h_j = jax.jit(lambda p, x, m: simnet_apply(
            p, jcfg, x, m, attn_impl="int8_block"))(
            params, jnp.asarray(x), jnp.asarray(mask))
    finally:
        jax.clear_caches()
    with torch.no_grad():
        s_t, h_t = model(torch.from_numpy(x), torch.from_numpy(mask),
                         attn_impl="int8_block")
    _close(s_t.numpy(), np.asarray(s_j), "scores")
    _close(h_t.numpy(), np.asarray(h_j), "hidden")


def test_int8_demotions(monkeypatch):
    """130 frames and a CLS token at 128 frames (n_eff 129) take exactly
    "int8_dense"; past the kernel's envelope the route leaves quantisation
    for exactly "flash" (lossless)."""
    calls = []
    real = simnet_mod.fused_encoder_block_int8

    def spy(*args, **kw):
        calls.append(args[1].shape)
        return real(*args, **kw)

    monkeypatch.setattr(simnet_mod, "fused_encoder_block_int8", spy)
    rng = np.random.default_rng(9)
    for use_cls, N in ((False, 130), (True, 128), (False, 128)):
        *_, model = _pair(seed=9, use_cls=use_cls)
        x = torch.from_numpy(rng.normal(size=(2, N, KW["in_features"]))
                             .astype(np.float32))
        calls.clear()
        with torch.no_grad():
            got, _ = model(x, attn_impl="int8_block")
            want, _ = model(x, attn_impl="int8_dense")
        assert torch.equal(got, want)
        assert calls == ([] if (N + use_cls) % 128 else [(2, 128, D)] * 2)
    monkeypatch.setattr(simnet_mod, "fused_block_int8_supported",
                        lambda *a: False)
    calls.clear()
    with torch.no_grad():
        got, _ = model(x, attn_impl="int8_block")
        want, _ = model(x, attn_impl="flash")
    assert calls == [] and torch.equal(got, want)


def test_int8_route_value_errors_carry_the_jax_messages():
    jcfg, params, _, model = _pair()
    jcfg_pre, params_pre, _, model_pre = _pair(norm_first=True)
    x = np.zeros((1, 128, KW["in_features"]), np.float32)
    xt = torch.from_numpy(x)
    cases = [
        (lambda: model(xt, attn_impl="int8_block", deterministic=False,
                       generator=torch.Generator().manual_seed(0)),
         lambda: simnet_apply(params, jcfg, x, attn_impl="int8_block",
                              deterministic=False,
                              rng=jax.random.PRNGKey(0))),
        (lambda: model(xt, attn_impl="int8_dense", return_attn=True),
         lambda: simnet_apply(params, jcfg, x, attn_impl="int8_xla",
                              return_attn=True)),
        (lambda: model_pre(xt, attn_impl="int8_block"),
         lambda: simnet_apply(params_pre, jcfg_pre, x,
                              attn_impl="int8_block")),
        (lambda: model(xt, attn_impl="int8_block", attn_fn=lambda *a: a),
         lambda: simnet_apply(params, jcfg, x, attn_impl="int8_block",
                              attn_fn=lambda *a: a)),
    ]
    for port, ref in cases:
        with pytest.raises(ValueError) as got:
            port()
        with pytest.raises(ValueError) as want:
            ref()
        assert str(got.value) == str(want.value)
        assert "int8 scoring path" in str(got.value)


def _dequantised_solo(model, cfg, feats):
    n = feats.shape[0]
    nb = bucket_length(n, 128)
    row = np.full((nb, cfg.in_features), 1000.0, np.float32)
    row[:n] = feats
    q, s = transport.quantize_frames(row)
    x = (torch.from_numpy(q).float() * torch.from_numpy(s)[:, None])[None]
    mask = np.ones((1, nb), bool)
    mask[0, :n] = False
    fwd = make_eval_forward(cfg, "int8_block", device="cpu")
    return fwd(model, x, mask)[0, :n].numpy()


@pytest.mark.parametrize("wire_mode", ["rows", "coalesced"])
def test_int8_wire_service_serves_solo_scores(wire_mode):
    """The int8 wire with the int8 route on the CPU: each request's served
    scores equal its solo scores on the dequantised input bit for bit, and
    a summary comes back binary and within budget."""
    *_, cfg, model = _pair(seed=11)
    rng = np.random.default_rng(11)
    videos = [rng.normal(size=(n, cfg.in_features)).astype(np.float32)
              for n in (37, 100, 250, 300)]
    with ScoringService(model, cfg, device="cpu", attn_impl="int8_block",
                        wire_dtype="int8", wire_mode=wire_mode, max_batch=8,
                        max_delay_ms=200.0) as svc:
        assert svc._wire.int8 and svc._wire.dtype == torch.int8
        futs = [svc.submit(v, want_summary=i == 3)
                for i, v in enumerate(videos)]
        results = [f.result(timeout=120) for f in futs]
        st = svc.stats()
    assert st.completed == len(videos) and st.failed == 0
    assert max(st.batch_hist) >= 2
    for v, r in zip(videos, results):
        np.testing.assert_array_equal(r.scores,
                                      _dequantised_solo(model, cfg, v))
    s = results[3].summary
    assert s.shape == (300,) and set(np.unique(s)) <= {0, 1}
    assert 0 < s.sum() <= int(0.15 * 300)


def _load_jax_probe():
    """scripts/probe_int8_mxu.py parses sys.argv when it is imported."""
    path = os.path.join(REPO, "scripts", "probe_int8_mxu.py")
    saved = sys.argv
    sys.argv = [path]
    try:
        spec = importlib.util.spec_from_file_location("_probe_int8_mxu", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.argv = saved
    return mod


def test_probe_plain_versions_match_the_pallas_kernels():
    """Kernel 18 at 256^3 (tile 128): the int8 product with its shift
    epilogue bit-equal, the bf16 one within one bf16 step."""
    from jax.experimental import pallas as pl

    mod = _load_jax_probe()
    M = N = K = 256
    t = 128

    def mm(kernel, dtype):
        return jax.jit(pl.pallas_call(
            kernel, grid=(M // t, N // t),
            in_specs=[pl.BlockSpec((t, K), lambda i, j: (i, 0)),
                      pl.BlockSpec((K, t), lambda i, j: (0, j))],
            out_specs=pl.BlockSpec((t, t), lambda i, j: (i, j)),
            out_shape=jax.ShapeDtypeStruct((M, N), dtype), interpret=True))

    rng = np.random.default_rng(12)
    a8 = rng.integers(-127, 128, size=(M, K)).astype(np.int8)
    b8 = rng.integers(-127, 128, size=(K, N)).astype(np.int8)
    want8 = np.asarray(mm(mod._mm_kernel_int8, jnp.int8)(a8, b8))
    got8 = probe.mm_int8(torch.from_numpy(a8),
                         torch.from_numpy(b8.T.copy()))
    assert got8.dtype == torch.int8
    np.testing.assert_array_equal(got8.numpy(), want8)
    assert len(np.unique(want8)) > 200     # the low 8 bits wrap around

    ab = rng.normal(size=(M, K)).astype(np.float32)
    bb = rng.normal(size=(K, N)).astype(np.float32)
    want = np.asarray(mm(mod._mm_kernel_bf16, jnp.bfloat16)(
        jnp.asarray(ab, jnp.bfloat16), jnp.asarray(bb, jnp.bfloat16)),
        np.float32)
    got = probe.mm_bf16(torch.from_numpy(ab).bfloat16(),
                        torch.from_numpy(bb.T.copy()).bfloat16())
    assert got.dtype == torch.bfloat16
    # one bf16 step at |want| (2^-7 |want| >= it), plus the bound on an f32
    # sum's rounding in another order (K 2^-24 sum|a||b|), which a result
    # near 0 from cancellation can exceed a step by
    a = np.asarray(jnp.asarray(ab, jnp.bfloat16), np.float64)
    b = np.asarray(jnp.asarray(bb, jnp.bfloat16), np.float64)
    tol = np.abs(want) * 2.0 ** -7 + K * 2.0 ** -24 * (np.abs(a) @ np.abs(b))
    assert np.all(np.abs(got.float().numpy() - want) <= tol)


@pytest.mark.parametrize("M,N,ln_rows,want", [
    (16384, 768, False, (128, 256)),   # (32, 512): QKV
    (16384, 256, True, (128, 256)),    # proj + LN1, fc2 + LN2
    (16384, 1024, False, (128, 256)),  # fc1
    (2048, 768, False, (128, 128)),    # (8, 256): QKV
    (2048, 1024, False, (128, 128)),   # fc1
    (2048, 256, True, (64, 256)),      # LayerNorm rows in one tile
    (2048, 2048, False, (128, 256)),   # the probe (kernel 18b)
    (8192, 8192, False, (128, 256)),
    (200, 100, True, (64, 128)),       # a short row fits 128 columns
    (2048, 768, True, (128, 128)),     # a row past 256: the row kernel
])
def test_int8_gemm_tile_rule(M, N, ln_rows, want):
    """The int8 wgmma kernel's CTA tile is a pure function of the grid on
    an H100's 132 SMs: a smaller tile only where its waves of tile area
    save more than an eighth (8192^3's wave tail does not), and a LayerNorm
    row of up to 256 columns always inside one tile."""
    bm, bn = quant.int8_gemm_tile(M, N, 132, ln_rows)
    assert (bm, bn) == want
    assert (bm, bn) in quant.INT8_TILES
    if ln_rows and N <= 256:
        assert bn >= N
