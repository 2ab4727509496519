"""The port's ScoringService on the CPU (``device="cpu"``): the same requests
give the JAX service's scores and bit-equal summaries, served scores equal
solo scores bit for bit, and admission control (overload, length caps,
deadlines) behaves as in tests/test_serve.py. Also: importing the port pulls
in neither JAX nor the JAX package."""

import subprocess
import sys

import jax
import numpy as np
import pytest

from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet
from vidsum_tpu.serve import ScoringService as JaxScoringService
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.data.collate import bucket_length
from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.serve import (
    DeadlineExceeded, RequestTooLong, ScoringService, ServiceOverloaded,
)
from vidsum_tpu_torch.serve.mesh import _single_chip_max_len
from vidsum_tpu_torch.train.steps import make_eval_forward

KW = dict(in_features=32, d_model=64, num_heads=4, num_layers=2,
          max_len=512)
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def pair():
    jparams = init_simnet(jax.random.PRNGKey(0),
                          JaxModelConfig(dropout=0.0, **KW))
    model = SimNet(CFG, device="cpu")
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams)))
    return jparams, model


def _video(rng, n):
    return rng.normal(size=(n, CFG.in_features)).astype(np.float32)


def _solo_scores(model, feats, attn_impl="dense"):
    n = feats.shape[0]
    nb = bucket_length(n, 128)
    x = np.full((1, nb, CFG.in_features), 1000.0, np.float32)
    mask = np.ones((1, nb), bool)
    x[0, :n] = feats
    mask[0, :n] = False
    fwd = make_eval_forward(CFG, attn_impl, device="cpu")
    return fwd(model, x, mask)[0, :n].numpy()


def _service(model, **kw):
    return ScoringService(model, CFG, device="cpu", **kw)


def _stalled_service(model, max_queue_depth):
    """A dispatcher parked on a huge batching window: admitted requests stay
    unresolved until close() flushes the window."""
    return _service(model, max_batch=64, max_delay_ms=60_000.0,
                    max_queue_depth=max_queue_depth)


def test_service_matches_jax_service(pair):
    jparams, model = pair
    rng = np.random.default_rng(0)
    videos = [_video(rng, n) for n in (37, 100, 250, 300)]
    cps = np.asarray([[0, 99], [100, 199], [200, 299]], np.int64)
    kws = [{}, {}, {}, {"change_points": cps}]
    with _service(model, max_batch=8, max_delay_ms=200.0) as svc:
        got = [f.result(timeout=120) for f in
               [svc.submit(v, **k) for v, k in zip(videos, kws)]]
    with JaxScoringService(jparams, JaxModelConfig(dropout=0.0, **KW),
                           max_batch=8, max_delay_ms=200.0) as jsvc:
        want = [f.result(timeout=120) for f in
                [jsvc.submit(v, **k) for v, k in zip(videos, kws)]]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.scores, w.scores, rtol=1e-5, atol=1e-5)
        np.testing.assert_array_equal(g.change_points, w.change_points)
        np.testing.assert_array_equal(g.summary, w.summary)


@pytest.mark.parametrize("attn_impl,wire_mode,wire_dtype", [
    ("dense", "rows", "auto"), ("fused_block", "rows", "float32"),
    ("flash", "coalesced", "auto"), ("dense", "coalesced", "bfloat16"),
])
def test_served_scores_equal_solo(pair, attn_impl, wire_mode, wire_dtype):
    """No op of the scorer mixes batch rows, so batch composition (repeated
    pad rows included) cannot perturb a request's scores. A bf16 wire is
    lossless for an f32 model only when the features are bf16 already."""
    _, model = pair
    rng = np.random.default_rng(1)
    videos = [_video(rng, n) for n in (37, 100, 128, 250, 256, 300)]
    if wire_dtype == "bfloat16":
        videos = [np.asarray(v.astype(np.float32).view(np.uint32)
                             & 0xFFFF0000).view(np.float32) for v in videos]
    with _service(model, attn_impl=attn_impl, wire_mode=wire_mode,
                  wire_dtype=wire_dtype, max_batch=8,
                  max_delay_ms=200.0) as svc:
        results = [f.result(timeout=120) for f in
                   [svc.submit(v, want_summary=False) for v in videos]]
        st = svc.stats()
    for v, r in zip(videos, results):
        assert r.scores.shape == (v.shape[0],) and r.summary is None
        np.testing.assert_array_equal(r.scores,
                                      _solo_scores(model, v, attn_impl))
        assert np.all((r.scores > 0) & (r.scores < 1))
    assert st.completed == len(videos) and st.failed == 0
    assert max(st.batch_hist) >= 2


def test_overload_rejects_before_device_work(pair):
    _, model = pair
    rng = np.random.default_rng(20)
    videos = [_video(rng, 50) for _ in range(4)]
    svc = _stalled_service(model, max_queue_depth=4)
    try:
        futs = [svc.submit(v, want_summary=False) for v in videos]
        with pytest.raises(ServiceOverloaded, match="max_queue_depth=4"):
            svc.submit(videos[0], want_summary=False)
    finally:
        svc.close()
    for v, f in zip(videos, futs):
        np.testing.assert_array_equal(f.result(timeout=120).scores,
                                      _solo_scores(model, v))
    st = svc.stats()
    assert st.rejected == 1 and st.requests == 4 and st.completed == 4
    assert svc._inflight == 0


def test_deadline_expires_undispatched_request(pair):
    _, model = pair
    rng = np.random.default_rng(22)
    ok_video, late_video = _video(rng, 50), _video(rng, 60)
    svc = _stalled_service(model, max_queue_depth=16)
    try:
        f_ok = svc.submit(ok_video, want_summary=False)
        f_late = svc.submit(late_video, want_summary=False, deadline_s=-1.0)
    finally:
        svc.close()
    np.testing.assert_array_equal(f_ok.result(timeout=120).scores,
                                  _solo_scores(model, ok_video))
    with pytest.raises(DeadlineExceeded):
        f_late.result(timeout=120)
    st = svc.stats()
    assert st.expired == 1 and st.completed == 1 and st.failed == 0
    assert svc._inflight == 0


def test_length_caps_reject_at_submit(pair):
    _, model = pair
    rng = np.random.default_rng(23)
    with _service(model, max_delay_ms=0.0, max_request_len=256) as svc:
        with pytest.raises(RequestTooLong, match="max_request_len=256"):
            svc.submit(_video(rng, 300), want_summary=False)
        r = svc.submit(_video(rng, 256), want_summary=False).result(120)
        assert r.scores.shape == (256,)
    assert svc.stats().rejected == 1
    # a kernel-impl service caps at the kernel ladder's envelope, the same
    # length the JAX package's service caps at
    from vidsum_tpu.serve import _single_chip_max_len as jax_cap

    with _service(model, attn_impl="flash", max_delay_ms=0.0) as svc:
        cap = svc._short_cap
        assert cap == _single_chip_max_len(CFG, 128) == jax_cap(
            JaxModelConfig(**KW), 128)
        with pytest.raises(RequestTooLong, match="single-chip kernel ladder"):
            svc.submit(np.zeros((cap + 1, CFG.in_features), np.float32),
                       want_summary=False)


def test_submit_validation_and_later_slices(pair):
    _, model = pair
    with _service(model, max_delay_ms=0.0) as svc:
        with pytest.raises(ValueError, match="features must be"):
            svc.submit(np.zeros((4, CFG.in_features + 1), np.float32))
        with pytest.raises(ValueError, match="picks is required"):
            svc.submit(np.zeros((4, CFG.in_features), np.float32),
                       n_frames=100)
    with pytest.raises(RuntimeError, match="closed"):
        svc.submit(np.zeros((4, CFG.in_features), np.float32))
    # the int8 wire on a mesh scores (tests/test_torch_parallel.py holds
    # its scores); the coalesced wire stays single-device only
    from vidsum_tpu_torch.parallel import make_mesh

    with _service(model, mesh=make_mesh((1, 2), "cpu"), wire_dtype="int8",
                  max_delay_ms=0.0) as svc:
        r = svc.submit(np.zeros((4, CFG.in_features), np.float32),
                       want_summary=False).result(timeout=60)
        assert r.scores.shape == (4,) and np.all(np.isfinite(r.scores))
    with pytest.raises(ValueError, match="single-chip only"):
        _service(model, mesh=make_mesh((2, 1), "cpu"), wire_mode="coalesced")
    with pytest.raises(ValueError, match="wire_dtype must be"):
        _service(model, wire_dtype="int4")


def test_port_imports_neither_jax_nor_the_jax_package():
    """Importing every module of the port in a fresh interpreter leaves jax
    and vidsum_tpu out of sys.modules, and the packages the card's machine
    does not have (h5py, yaml, flax, optax, msgpack, cv2, PIL) too. The
    int8 slice's modules, the sequence-parallel ones, the finetune
    protocol's (data, checkpoints, the msgpack reader, the CLIs) and the
    raw-video path's (preprocess, pipeline, device eval, the exports, the
    summarize and build_dataset CLIs) and the multi-device modes'
    (data, tensor and pipeline parallelism, multi-process runs) are among
    those imported."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import vidsum_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "roots = ('jax', 'vidsum_tpu', 'h5py', 'yaml', 'flax', 'optax',\n"
        "         'msgpack', 'cv2', 'PIL')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in roots)\n"
        "n = sum(k.startswith('vidsum_tpu_torch') for k in sys.modules)\n"
        "new = ['ops.quant', 'ops.block_kernel_int8', 'serve_http',\n"
        "       'cli.serve', 'tools.probe_int8_mma', 'parallel.mesh',\n"
        "       'parallel.ring_attention', 'parallel.seq_forward',\n"
        "       'data.datasets', 'data.splits', 'data.synthetic',\n"
        "       'train.checkpoint', 'train.flax_msgpack', 'train.finetune',\n"
        "       'cli.train', 'cli.evaluate', 'export.summary_json',\n"
        "       'ops.segmentation', 'ops.legacy_eval', 'utils.profiling',\n"
        "       'utils.metrics_log', 'ops.device_eval', 'pipeline',\n"
        "       'preprocess.nn', 'preprocess.googlenet', 'preprocess.r3d',\n"
        "       'preprocess.transforms', 'preprocess.reduce_fps',\n"
        "       'preprocess.extract', 'preprocess.annotations',\n"
        "       'preprocess.build_dataset', 'export.attention',\n"
        "       'export.frames', 'cli.summarize', 'cli.build_dataset',\n"
        "       'parallel.dp_shardmap', 'parallel.train_parallel',\n"
        "       'parallel.sharding', 'parallel.pipeline',\n"
        "       'parallel.distributed']\n"
        "missing = [m for m in new if 'vidsum_tpu_torch.' + m\n"
        "           not in sys.modules]\n"
        "print(n, bad, missing)\n"
        "sys.exit(1 if bad or missing or n < 20 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
