"""The port's HTTP front-end (``vidsum_tpu_torch/serve_http.py``) over a CPU
``ScoringService`` (``device="cpu"``), with the status mapping of
tests/test_serve.py (200, 400, 404, 413 for a body past the cap and for a
request past the length cap, 503 with ``Retry-After``, 504 on an expired
deadline, a JSON 500 on a closed service), and the port's serving CLI
against the JAX package's (the same flags and defaults; the options of
later slices raise)."""

import io
import json
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from vidsum_tpu.cli import serve as jax_cli
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.models import init_simnet
from vidsum_tpu_torch.cli import serve as cli
from vidsum_tpu_torch.config import ModelConfig
from vidsum_tpu_torch.models.convert import (
    load_torch_checkpoint, params_from_jax,
)
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.serve import ScoringService
from vidsum_tpu_torch.serve_http import make_server, run_in_thread

KW = dict(in_features=32, d_model=64, num_heads=2, num_layers=2,
          max_len=512)
CFG = ModelConfig(**KW)


@pytest.fixture(scope="module")
def model():
    params = init_simnet(jax.random.PRNGKey(0),
                         JaxModelConfig(dropout=0.0, **KW))
    m = SimNet(CFG, device="cpu")
    m.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, params)))
    return m


def _video(rng, n):
    return rng.normal(size=(n, CFG.in_features)).astype(np.float32)


def _npz(**arrays):
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    return buf.getvalue()


def _post(host, port, path, body):
    req = urllib.request.Request(f"http://{host}:{port}{path}", data=body,
                                 method="POST")
    return urllib.request.urlopen(req, timeout=120)


@pytest.mark.parametrize("attn_impl,wire_dtype", [
    ("int8_block", "int8"), ("dense", "auto")])
def test_http_roundtrip(model, attn_impl, wire_dtype):
    """200 with the service's own scores and summary; /healthz, /stats; a
    malformed payload 400 and an unknown path 404, the server alive."""
    rng = np.random.default_rng(5)
    feats = _video(rng, 70)
    with ScoringService(model, CFG, device="cpu", attn_impl=attn_impl,
                        wire_dtype=wire_dtype, max_delay_ms=0.0) as svc:
        server = make_server(svc, port=0)
        run_in_thread(server)
        host, port = server.server_address
        try:
            with _post(host, port, "/summarize", _npz(features=feats)) as r:
                assert r.status == 200
                out = json.loads(r.read())
            want = svc.summarize(feats)
            np.testing.assert_array_equal(
                np.asarray(out["scores"], np.float32), want.scores)
            assert out["summary_frames"] == np.nonzero(want.summary)[0].tolist()
            assert out["change_points"] == want.change_points.tolist()
            assert out["n_frames"] == 70
            with _post(host, port, "/summarize?summary=0&budget=0.2",
                       _npz(features=feats)) as r:
                out = json.loads(r.read())
            assert "summary_frames" not in out and len(out["scores"]) == 70
            with urllib.request.urlopen(f"http://{host}:{port}/healthz",
                                        timeout=30) as r:
                assert json.loads(r.read()) == {"ok": True}
            with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                        timeout=30) as r:
                st = json.loads(r.read())
            assert st["completed"] >= 3 and st["failed"] == 0
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(host, port, "/summarize", b"not npz")
            assert ei.value.code == 400
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(host, port, "/score", _npz(features=feats))
            assert ei.value.code == 404
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"http://{host}:{port}/nope",
                                       timeout=30)
            assert ei.value.code == 404
            assert "error" in json.loads(ei.value.read())
        finally:
            server.shutdown()


def test_http_admission_statuses(model):
    """503 on overload (with Retry-After), 413 on a request past
    ``max_request_len`` and on a body past the cap, 504 on an expired
    deadline, a JSON 500 (not a dropped connection) on a closed service."""
    rng = np.random.default_rng(27)
    feats = _video(rng, 60)
    svc = ScoringService(model, CFG, device="cpu", max_batch=64,
                         max_delay_ms=60_000.0, max_queue_depth=1,
                         max_request_len=256)
    server = make_server(svc, port=0, max_body_bytes=200_000)
    run_in_thread(server)
    host, port = server.server_address
    try:
        f_held = svc.submit(feats, want_summary=False)  # fills the depth
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/summarize", _npz(features=feats))
        assert ei.value.code == 503
        assert ei.value.headers["Retry-After"] is not None
        assert "error" in json.loads(ei.value.read())

        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/summarize", _npz(features=_video(rng, 300)))
        assert ei.value.code == 413
        assert "max_request_len" in json.loads(ei.value.read())["error"]

        big = np.zeros((2000, CFG.in_features), np.float32)  # > body cap
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/summarize", _npz(features=big))
        assert ei.value.code == 413
        assert "max_body_bytes" in json.loads(ei.value.read())["error"]
    finally:
        svc.close()   # flushes the stalled window
    f_held.result(timeout=120)

    with ScoringService(model, CFG, device="cpu", max_delay_ms=0.0) as svc2:
        server.service = svc2
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(host, port, "/summarize?deadline=-1", _npz(features=feats))
        assert ei.value.code == 504
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(host, port, "/summarize", _npz(features=feats))
    assert ei.value.code == 500
    assert "error" in json.loads(ei.value.read())
    server.shutdown()


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions}


def test_cli_parser_matches_jax():
    assert _actions(cli.build_parser()) == _actions(jax_cli.build_parser())
    args = cli.build_parser().parse_args(["--attn", "int8_block",
                                          "--wire_dtype", "int8"])
    assert (args.attn, args.wire_dtype, args.port) == ("int8_block", "int8",
                                                       8080)


@pytest.mark.parametrize("argv,match", [
    (["--devices", "2"], "multi-GPU slice"),
    (["--recycle_after_mb", "4000"], "later slice"),
    (["--recycle_after_requests", "100"], "later slice"),
])
def test_cli_later_slices_raise(argv, match):
    with pytest.raises(NotImplementedError, match=match):
        cli.main(argv)


@pytest.mark.parametrize("fmt", ["flax", "torch"])
def test_cli_load_model_reads_both_checkpoint_formats(tmp_path, model, fmt):
    """``--ckpt`` takes the JAX package's msgpack file and the port's
    torch.save file of the same weights to the same state_dict, and the
    CLI's service over it scores as one over the original model; without a
    checkpoint the model keeps its seeded random weights."""
    from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint
    from vidsum_tpu_torch.models.convert import params_to_jax
    from vidsum_tpu_torch.train.checkpoint import save_checkpoint

    path = str(tmp_path / "model_mae.ckpt")
    if fmt == "flax":
        jax_save_checkpoint(path, params_to_jax(model.state_dict()))
    else:
        save_checkpoint(path, model.state_dict(), meta={"epoch": 0})
    args = cli.build_parser().parse_args(["--ckpt", path])
    loaded = cli.load_model(args, CFG, device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    feats = np.random.default_rng(2).normal(size=(200, KW["in_features"]))
    scores = []
    for m in (model, loaded):
        with cli.make_service(args, CFG, m, device="cpu") as svc:
            scores.append(svc.submit(feats.astype(np.float32)).result(
                timeout=60).scores)
    np.testing.assert_array_equal(*scores)
    fresh = cli.load_model(cli.build_parser().parse_args([]), CFG,
                           device="cpu")
    assert not torch.equal(fresh.final_layer.weight,
                           model.final_layer.weight)


def test_cli_runs_on_the_card_only(tmp_path, model):
    """Without a card the CLI stops before serving; a reference .pth (the
    positional-encoding buffer included) loads into SimNet as it is."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--warmup", ""])
    state = dict(model.state_dict())
    state["embedding_layer.pe"] = torch.zeros(512, KW["d_model"])
    path = tmp_path / "model_mae.pth"
    torch.save(state, path)
    m = SimNet(CFG, device="cpu")
    m.load_state_dict(load_torch_checkpoint(str(path)))
    for k, v in model.state_dict().items():
        assert torch.equal(m.state_dict()[k], v)
