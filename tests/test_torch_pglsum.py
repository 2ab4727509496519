"""PGL-SUM on the port (``models/pglsum.py``) against the plain reference
the benchmark holds it to (``benchmark/reference/pglsum.py``, written from
the public code's equations), on the CPU at a small width: both routes'
scores, padded batches against solo videos, the public state-dict names,
the settings it refuses, serving and the CLIs. This file imports no JAX."""

import json

import numpy as np
import pytest
import torch

from benchmark.reference import pglsum as ref
from benchmark.reference import summary as ref_summary
from vidsum_tpu_torch.cli import evaluate as evaluate_cli
from vidsum_tpu_torch.cli import serve as serve_cli
from vidsum_tpu_torch.config import pglsum_config
from vidsum_tpu_torch.data.synthetic import make_synthetic_h5
from vidsum_tpu_torch.models import build_scorer
from vidsum_tpu_torch.models.pglsum import PGLSum
from vidsum_tpu_torch.ops.attention import position_bias, position_bias_den
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.train.checkpoint import save_checkpoint
from vidsum_tpu_torch.train.steps import make_eval_forward

# 64 wide: 2 global heads of 32, 4 segments of 2 heads of 8
CFG = pglsum_config(in_features=64, d_model=64, num_heads=2, local_heads=2)
REF_CFG = {"in_features": 64, "num_heads": 2, "num_segments": 4,
           "local_heads": 2, "pos_freq": 10000}


@pytest.fixture(scope="module")
def models():
    model = PGLSum(CFG, device="cpu",
                   generator=torch.Generator().manual_seed(3))
    reference = ref.PGLSum(REF_CFG)
    reference.load_state_dict(model.state_dict())
    return model, reference.eval()


def _video(T, seed=0, d=64):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(T, d)).astype(np.float32))


def _padded(videos, N, pad_value=1000.0):
    x = torch.full((len(videos), N, videos[0].shape[1]), pad_value)
    mask = torch.ones((len(videos), N), dtype=torch.bool)
    for i, v in enumerate(videos):
        x[i, :v.shape[0]] = v
        mask[i, :v.shape[0]] = False
    return x, mask


@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("T", [1, 3, 5, 130, 257])
def test_routes_match_the_reference(models, impl, T):
    """Odd T (a zero last bias column), T < 4 (empty segments), 130 and 257
    (an unequal last segment); ``flash`` is the kernel route's structure
    (segment gather, per-element lengths) on the wrappers' plain
    versions."""
    model, reference = models
    x = _video(T, seed=T)
    want = ref.scores(reference, x)
    fwd = make_eval_forward(CFG, attn_impl=impl, device="cpu")
    got = fwd(model, x[None], torch.zeros((1, T), dtype=torch.bool))[0]
    assert got.shape == (T,)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_position_bias_is_the_public_codes():
    """The port's bias (the CPU side of the kernel's) equals the
    reference's T x T table at odd and even T, the last column of an odd T
    zero; past the float32 power's overflow the pairs are sin 0, cos 0."""
    att = ref.SelfAttention(1024, 1024, 10000, 1)
    den = position_bias_den(8192, 1024, 10000, "cpu")
    for T in (1, 6, 7, 64):
        want = att.absolute_position(T)
        got = position_bias(T, den)
        torch.testing.assert_close(got, want, atol=1e-6, rtol=0)
        if T % 2:
            assert not got[:, -1].any()
    assert torch.isinf(den[4933]) and not torch.isinf(den[4932])
    tail = position_bias(9990, den[:4995], rows=3)[:, 9866:9990]
    assert torch.equal(tail[:, 0::2], torch.zeros_like(tail[:, 0::2]))
    assert torch.equal(tail[:, 1::2], torch.ones_like(tail[:, 1::2]))


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_padded_batch_scores_each_video_as_alone(models, impl):
    """Three videos padded to 384 rows (pad value 1,000) score bit for bit
    as each alone, padded to its own 128-row bucket: every video has its
    own T, segments and bias, and padded rows are never keys."""
    model, _ = models
    videos = [_video(T, seed=T) for T in (130, 257, 5)]
    x, mask = _padded(videos, 384)
    batch, _ = model(x, mask, attn_impl=impl)
    for i, v in enumerate(videos):
        T = v.shape[0]
        xs, ms = _padded([v], -(-T // 128) * 128)
        alone, _ = model(xs, ms, attn_impl=impl)
        assert torch.equal(batch[i, :T], alone[0, :T])


def test_public_state_dict_loads_by_name(tmp_path):
    """A state dict the reference module writes (the public names) loads
    into ``PGLSum`` by name, through a checkpoint file as ``--ckpt`` reads
    it, and scores as the reference does; the published size has 9.44 M
    parameters."""
    fresh = ref.PGLSum(REF_CFG)
    with torch.no_grad():
        for p in fresh.parameters():
            p.uniform_(-0.2, 0.2, generator=torch.Generator().manual_seed(
                p.numel()))
    path = tmp_path / "pglsum.pth"
    torch.save(fresh.state_dict(), path)
    assert set(fresh.state_dict()) == set(ref.param_shapes(REF_CFG))
    model = PGLSum(CFG, device="cpu")
    model.load_state_dict(torch.load(path, weights_only=True))
    x = _video(200, seed=9)
    got, _ = model(x[None], None)
    torch.testing.assert_close(torch.sigmoid(got[0, :, 0]),
                               ref.scores(fresh, x), atol=1e-6, rtol=0)
    assert sum(p.numel() for p in PGLSum(pglsum_config(), device="cpu")
               .parameters()) == 9_443_329


@pytest.mark.parametrize("case", ["relative", "fusion", "bfloat16",
                                  "int8_block", "attn_fn", "training"])
def test_settings_it_does_not_take_raise(models, case):
    model, _ = models
    x = _video(8)[None]
    with pytest.raises(ValueError):
        if case == "relative":
            PGLSum(pglsum_config(pos_enc="relative"), device="cpu")
        elif case == "fusion":
            PGLSum(pglsum_config(fusion="mult"), device="cpu")
        elif case == "bfloat16":
            PGLSum(pglsum_config(compute_dtype="bfloat16"), device="cpu")
        elif case == "int8_block":
            model(x, None, attn_impl="int8_block")
        elif case == "attn_fn":
            model(x, None, attn_fn=lambda *a: a[0])
        else:
            model(x, None, deterministic=False,
                  generator=torch.Generator())


def test_counters_advance(models):
    """The kernel route counts its 17 kernel and GEMM launches; both routes
    count the non-empty segments (a 3-row video has three)."""
    model, _ = models
    before = (PGLSum.forwards, PGLSum.launches, PGLSum.segments())
    model(_video(3)[None], None, attn_impl="flash")
    model(_video(130)[None], None, attn_impl="dense")
    assert PGLSum.forwards - before[0] == 2
    assert PGLSum.launches - before[1] == 17
    assert PGLSum.segments() - before[2] == 3 + 4


def test_service_serves_the_references_scores_and_summary(models):
    """``ScoringService`` on the CPU with a PGL-SUM scorer: each video's
    served scores are the reference's and its summary the reference's
    knapsack over them."""
    model, reference = models
    rng = np.random.default_rng(5)
    lengths, stride = (60, 131, 250), 15
    with ScoringService(model, CFG, device="cpu", max_batch=4,
                        max_delay_ms=20.0) as svc:
        futs = []
        for T in lengths:
            feats = _video(T, seed=T + 1).numpy()
            cuts = np.sort(rng.choice(np.arange(1, stride * T), size=4,
                                      replace=False))
            cps = np.stack([np.concatenate([[0], cuts]),
                            np.concatenate([cuts - 1, [stride * T - 1]])],
                           axis=1)
            picks = np.arange(T) * stride
            futs.append((feats, cps, picks, svc.submit(
                feats, picks=picks, n_frames=stride * T, change_points=cps)))
        for feats, cps, picks, fut in futs:
            res = fut.result(timeout=120)
            want = ref.scores(reference, torch.from_numpy(feats)).numpy()
            np.testing.assert_allclose(res.scores, want, atol=1e-6, rtol=0)
            np.testing.assert_array_equal(res.summary, ref_summary.summary(
                want, cps, stride * len(feats), picks, 0.15))


def test_service_refuses_routes_pglsum_lacks(models):
    model, _ = models
    for kw in ({"attn_impl": "int8_dense"}, {"wire_dtype": "int8"},
               {"wire_dtype": "bfloat16"}):
        with pytest.raises(ValueError):
            ScoringService(model, CFG, device="cpu", **kw)


def test_cli_serve_and_evaluate_build_pglsum(tmp_path, monkeypatch, capsys):
    """``--arch pglsum``: ``cli.serve`` builds a published-size ``PGLSum``,
    and ``cli.evaluate`` scores a dataset with one loaded by name from a
    checkpoint; the default stays SimNet."""
    args = serve_cli.build_parser().parse_args(["--arch", "pglsum"])
    cfg = serve_cli.scorer_config(args)
    model = serve_cli.load_model(args, cfg, device="cpu")
    assert isinstance(model, PGLSum) and model.cfg.in_features == 1024
    default = serve_cli.build_parser().parse_args([])
    assert type(build_scorer(serve_cli.scorer_config(default),
                             device="cpu")).__name__ == "SimNet"

    built = []

    def spy(cfg, device=None, generator=None):
        built.append(build_scorer(cfg, device=device, generator=generator))
        return built[-1]

    monkeypatch.setattr("vidsum_tpu_torch.models.build_scorer", spy)
    data = tmp_path / "data"
    data.mkdir()
    make_synthetic_h5(str(data / "summarizer_dataset_tvsum_google_pool5.h5"),
                      n_videos=3, min_picks=40, max_picks=70)
    ckpt = str(tmp_path / "pglsum.ckpt")
    save_checkpoint(ckpt, model.state_dict())
    evaluate_cli.main(["--data", str(data), "--ckpt", ckpt, "--arch",
                       "pglsum"], device="cpu")
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert isinstance(built[0], PGLSum) and 0.0 <= out["fscore"] <= 100.0
