"""The port's finetune protocol against the JAX package's, on the CPU
(``device="cpu"``): checkpoints (the port's ``torch.save`` files, the
asynchronous writer, and the plain-Python reader of the JAX msgpack files
held against ``flax.serialization``), ``finetune()`` over two folds from the
same JAX-written ``pretrain.ckpt`` at dropout 0 (results, per-epoch metric
records, ``summary.json``, the warm start of fold 2 from fold 1's saved
file), exact resume, resume from a JAX-written ``train_state.ckpt``, the
tracer, and the train / evaluate CLIs (parsers and
printed JSON)."""

import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch
from flax import serialization

from vidsum_tpu.cli import evaluate as jax_evaluate_cli
from vidsum_tpu.cli import train as jax_train_cli
from vidsum_tpu.config import Config as JaxConfig
from vidsum_tpu.config import DataConfig as JaxDataConfig
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.config import TrainConfig as JaxTrainConfig
from vidsum_tpu.data.paths import PATH as JAX_PATH
from vidsum_tpu.data.synthetic import make_synthetic_h5
from vidsum_tpu.models import init_simnet
from vidsum_tpu.train import finetune as jax_finetune
from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint
from vidsum_tpu.train.steps import make_optimizer as jax_make_optimizer
from vidsum_tpu_torch.cli import evaluate as evaluate_cli
from vidsum_tpu_torch.cli import train as train_cli
from vidsum_tpu_torch.config import Config, DataConfig, ModelConfig
from vidsum_tpu_torch.config import TrainConfig
from vidsum_tpu_torch.models.convert import params_from_jax
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.train import checkpoint as ck
from vidsum_tpu_torch.train import finetune as ft
from vidsum_tpu_torch.train import flax_msgpack
from vidsum_tpu_torch.train.steps import make_optimizer
from vidsum_tpu_torch.utils.metrics_log import MetricsLogger
from vidsum_tpu_torch.utils.profiling import trace

# the CLIs build ModelConfig(in_features=1024), so the data has 1024 features
KW = dict(d_model=32, num_heads=4, num_layers=1)
SPLITS = [{"train_keys": [f"x.h5/video_{i}" for i in range(4)],
           "test_keys": ["x.h5/video_4", "x.h5/video_5"]},
          {"train_keys": [f"x.h5/video_{i}" for i in range(2, 6)],
           "test_keys": ["x.h5/video_0", "x.h5/video_1"]}]
TRAIN = dict(lr=1e-3, weight_decay=1e-4, batch_size=2, max_epoch=2)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("ftdata")
    make_synthetic_h5(str(root / JAX_PATH["tvsum"]), n_videos=6, seed=11)
    return str(root)


@pytest.fixture(scope="module")
def jax_params():
    return jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(3),
                                JaxModelConfig(dropout=0.0, **KW)))


def _configs(data_root, **train):
    tr = {**TRAIN, **train}
    return (JaxConfig(model=JaxModelConfig(dropout=0.0, **KW),
                      data=JaxDataConfig(root=data_root),
                      train=JaxTrainConfig(**tr)),
            Config(model=ModelConfig(dropout=0.0, **KW),
                   data=DataConfig(root=data_root), train=TrainConfig(**tr)))


def _records(path):
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


@pytest.fixture(scope="module")
def fold_runs(data_root, jax_params, tmp_path_factory):
    """Both packages' finetune() over two folds of two epochs, from the same
    JAX-written pretrain.ckpt, fold 2 warm-started from fold 1's saved
    model file. Records the checkpoint files the port's loop reads."""
    jconf, conf = _configs(data_root, use_pretrained=True,
                           warm_start_from_save=True)
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(tmp_path_factory.mktemp(side))
        jax_save_checkpoint(os.path.join(dirs[side], "pretrain.ckpt"),
                            jax_params)
    jres = jax_finetune(jconf, SPLITS, workdir=dirs["jax"],
                        metrics_path=os.path.join(dirs["jax"], "m.jsonl"))
    loaded = []
    real = ft.load_model_state

    def recording(path):
        loaded.append(os.path.basename(path))
        return real(path)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ft, "load_model_state", recording)
        res = ft.finetune(conf, SPLITS, workdir=dirs["port"],
                          metrics_path=os.path.join(dirs["port"], "m.jsonl"),
                          device="cpu")
    return jres, res, dirs, loaded


def test_finetune_matches_jax(fold_runs):
    """FinetuneResult and per_split within 1e-5, every metric record but
    ``ts`` within rtol 1e-5 (f32 summation order in the train loss), the
    same keys, and summary.json byte for byte."""
    jres, res, dirs, _ = fold_runs
    got = [res.fscore, res.kendall_tau, res.spearman_rho]
    want = [jres.fscore, jres.kendall_tau, jres.spearman_rho]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert len(res.per_split) == len(jres.per_split) == 2
    for g, w in zip(res.per_split, jres.per_split):
        assert g.keys() == w.keys()
        np.testing.assert_allclose([g[k] for k in w], list(w.values()),
                                   rtol=1e-5, atol=1e-5)
    recs = _records(os.path.join(dirs["port"], "m.jsonl"))
    jrecs = _records(os.path.join(dirs["jax"], "m.jsonl"))
    assert len(recs) == len(jrecs) == 2 * 2 + 1
    for g, w in zip(recs, jrecs):
        assert g.keys() == w.keys() and "ts" in g
        for k in w:
            if k != "ts":
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    with open(os.path.join(dirs["port"], "summary.json")) as f, \
            open(os.path.join(dirs["jax"], "summary.json")) as g:
        assert f.read() == g.read()
    for name in ("model_mae.ckpt", "train_state.ckpt"):
        with open(os.path.join(dirs["port"], name + ".meta.json")) as f:
            meta = json.load(f)
        with open(os.path.join(dirs["jax"], name + ".meta.json")) as f:
            jmeta = json.load(f)
        assert meta.keys() == jmeta.keys()
        assert (meta["epoch"], meta["split"]) == (1, 1)


def test_fold_two_warm_starts_from_fold_one(fold_runs):
    """Fold 1 loads the pretrained file only (no saved model yet); fold 2
    the pretrained file, then fold 1's model_mae.ckpt (the port's own
    format), as the JAX loop does (its fold 2 results agree above)."""
    _, _, dirs, loaded = fold_runs
    assert loaded == ["pretrain.ckpt", "pretrain.ckpt", "model_mae.ckpt"]
    state, meta = ck.load_checkpoint(os.path.join(dirs["port"],
                                                  "model_mae.ckpt"))
    assert ck.checkpoint_format(os.path.join(dirs["port"],
                                             "model_mae.ckpt")) == "torch"
    assert meta == {"epoch": 1, "split": 1}
    assert set(state) == set(SimNet(ModelConfig(**KW),
                                    device="cpu").state_dict())


def test_resume_is_exact(data_root, tmp_path):
    """Two epochs then a resume to four give the bits of four straight
    epochs (dropout 0.1: the per-(split, epoch) streams), in the model file,
    the resume state and every metric record but ``ts``; the resumed run
    logs epochs 2 and 3 only."""
    _, conf = _configs(data_root, max_epoch=4)
    conf = dataclasses.replace(conf, model=dataclasses.replace(conf.model,
                                                               dropout=0.1))
    short = dataclasses.replace(conf, train=dataclasses.replace(
        conf.train, max_epoch=2))
    straight, resumed = str(tmp_path / "straight"), str(tmp_path / "resumed")
    kw = dict(export_summary=False, device="cpu")
    ft.finetune(conf, SPLITS[:1], workdir=straight,
                metrics_path=os.path.join(straight, "m.jsonl"), **kw)
    ft.finetune(short, SPLITS[:1], workdir=resumed,
                metrics_path=os.path.join(resumed, "m.jsonl"), **kw)
    ft.finetune(conf, SPLITS[:1], workdir=resumed, resume=True,
                metrics_path=os.path.join(resumed, "m.jsonl"), **kw)
    for name in ("model_mae.ckpt", "train_state.ckpt"):
        a, meta_a = ck.load_checkpoint(os.path.join(straight, name))
        b, meta_b = ck.load_checkpoint(os.path.join(resumed, name))
        assert meta_a == meta_b and meta_a["epoch"] == 3
        flat_a = jax.tree_util.tree_leaves_with_path(a)
        flat_b = jax.tree_util.tree_leaves_with_path(b)
        assert [p for p, _ in flat_a] == [p for p, _ in flat_b]
        for (path, x), (_, y) in zip(flat_a, flat_b):
            if isinstance(x, torch.Tensor):
                assert torch.equal(x, y), jax.tree_util.keystr(path)
            else:
                assert x == y, jax.tree_util.keystr(path)
    recs_a = _records(os.path.join(straight, "m.jsonl"))
    recs_b = _records(os.path.join(resumed, "m.jsonl"))
    assert [r["epoch"] for r in recs_b if "epoch" in r] == [0, 1, 2, 3]

    def strip(records):
        return [{k: v for k, v in r.items() if k != "ts"} for r in records]

    assert (strip([r for r in recs_b if "epoch" in r])
            == strip([r for r in recs_a if "epoch" in r]))
    assert strip(recs_b[-1:]) == strip(recs_a[-1:])


def test_resume_from_a_jax_state_file_matches_jax(data_root, tmp_path):
    """The JAX package finetunes one epoch and writes train_state.ckpt (its
    optax Adam state); both packages resume from that file to two epochs
    (dropout 0): the results, the per-fold metrics and the model file agree
    within rtol 1e-5."""
    import shutil

    jconf, conf = _configs(data_root, max_epoch=2)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(export_summary=False)
    jax_finetune(dataclasses.replace(jconf, train=dataclasses.replace(
        jconf.train, max_epoch=1)), SPLITS[:1], workdir=jdir, **kw)
    shutil.copytree(jdir, pdir)
    assert ck.checkpoint_format(os.path.join(pdir, "train_state.ckpt")) \
        == "flax"
    jres = jax_finetune(jconf, SPLITS[:1], workdir=jdir, resume=True, **kw)
    res = ft.finetune(conf, SPLITS[:1], workdir=pdir, resume=True,
                      device="cpu", **kw)
    np.testing.assert_allclose(
        [res.fscore, res.kendall_tau, res.spearman_rho],
        [jres.fscore, jres.kendall_tau, jres.spearman_rho], rtol=1e-5,
        atol=1e-5)
    got, meta = ck.load_model_state(os.path.join(pdir, "model_mae.ckpt"))
    want, jmeta = ck.load_model_state(os.path.join(jdir, "model_mae.ckpt"))
    assert meta == jmeta == {"epoch": 1, "split": 0}
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-7, err_msg=k)


def test_save_cadence_and_resume_from_a_gate(data_root, tmp_path):
    """state_save_every 3 / model_save_every 2 over five epochs: the last
    epoch always saves both; a resume to seven epochs continues after it
    (the JAX package's test_state_save_every_gating)."""
    _, conf = _configs(data_root, max_epoch=5, state_save_every=3,
                       model_save_every=2)
    saves = []
    real = ck._write

    def counting(path, tree, meta):
        saves.append((os.path.basename(path), meta["epoch"]))
        real(path, tree, meta)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ck, "_write", counting)
        ft.finetune(conf, SPLITS[:1], workdir=str(tmp_path),
                    export_summary=False, device="cpu")
    assert saves == [("model_mae.ckpt", 1), ("train_state.ckpt", 2),
                     ("model_mae.ckpt", 3), ("model_mae.ckpt", 4),
                     ("train_state.ckpt", 4)]
    longer = dataclasses.replace(conf, train=dataclasses.replace(
        conf.train, max_epoch=7))
    res = ft.finetune(longer, SPLITS[:1], workdir=str(tmp_path),
                      export_summary=False, resume=True, device="cpu",
                      metrics_path=str(tmp_path / "m.jsonl"))
    assert np.isfinite(res.fscore)
    assert [r["epoch"] for r in _records(tmp_path / "m.jsonl")
            if "epoch" in r] == [5, 6]


def test_batch_order_replaces_the_shuffle(data_root, tmp_path):
    """``batch_order(split, epoch)`` gives each epoch's batches: the JAX
    loop with the same order agrees."""
    jconf, conf = _configs(data_root, max_epoch=1)

    def order(split_idx, epoch):
        return [[3, 0], [1], [2]]

    jres = jax_finetune(jconf, SPLITS[:1], workdir=str(tmp_path / "j"),
                        export_summary=False, batch_order=order)
    res = ft.finetune(conf, SPLITS[:1], workdir=str(tmp_path / "p"),
                      export_summary=False, batch_order=order, device="cpu")
    np.testing.assert_allclose(res.per_split[0]["fscore"],
                               jres.per_split[0]["fscore"], rtol=1e-5)


def _flax_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), path
        for k in want:
            _flax_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _flax_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)) and \
            want.dtype.name == "bfloat16":
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(
            got.view(torch.int16).numpy().view(np.uint16),
            np.asarray(want).view(np.uint16), err_msg=path)
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, path


@pytest.mark.parametrize("kind", ["scorer", "train_state", "bf16_scalars"])
def test_flax_msgpack_reads_jax_checkpoints(tmp_path, jax_params, kind):
    """The plain-Python reader gives flax.serialization.msgpack_restore's
    tree for the JAX package's files: a scorer, a train state (params +
    the optax state with its int32 count and empty states), and bf16 /
    numpy-scalar / Python leaves."""
    if kind == "scorer":
        tree = jax_params
    elif kind == "train_state":
        opt = jax_make_optimizer(1e-3, 1e-4)
        tree = {"params": jax_params,
                "opt_state": jax.device_get(opt.init(jax_params))}
    else:
        tree = {"w": np.asarray(jax.numpy.arange(6, dtype=jax.numpy.bfloat16
                                                 ).reshape(2, 3)),
                "s": (np.int32(-5), np.float64(2.5), np.bool_(True)),
                "py": [1, -40, 70000, -2 ** 40, 0.5, None, True, "x" * 40],
                "e": np.zeros((0, 3), np.int8), "d": {}}
    path = str(tmp_path / "ck.msgpack")
    jax_save_checkpoint(path, tree, meta={"epoch": 2})
    with open(path, "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    _flax_equal(flax_msgpack.restore(data), want)
    assert ck.checkpoint_format(path) == "flax"
    got, meta = ck.load_checkpoint(path)
    _flax_equal(got, want)
    assert meta == {"epoch": 2}
    if kind == "scorer":
        state, _ = ck.load_model_state(path)
        expect = params_from_jax(jax_params)
        assert state.keys() == expect.keys()
        for k in expect:
            assert torch.equal(state[k], expect[k]), k
    if kind == "train_state":
        with pytest.raises(ValueError, match="not a SimNet parameter tree"):
            ck.load_model_state(path)


def test_flax_msgpack_refuses_what_it_does_not_read(tmp_path, monkeypatch):
    """A chunked array (flax splits leaves over 1 GiB), a complex leaf
    (extension type 2), truncated or trailing bytes, and a file of neither
    format raise ValueError naming the problem."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 16)
    chunked = serialization.msgpack_serialize({"x": np.zeros(40, np.float32)})
    monkeypatch.undo()
    with pytest.raises(ValueError, match="__msgpack_chunked_array__"):
        flax_msgpack.restore(chunked)
    with pytest.raises(ValueError, match="extension type 2"):
        flax_msgpack.restore(serialization.msgpack_serialize({"c": 1 + 2j}))
    good = serialization.msgpack_serialize({"a": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        flax_msgpack.restore(good[:-2])
    with pytest.raises(ValueError, match="trailing bytes"):
        flax_msgpack.restore(good + b"\x00")
    path = tmp_path / "notes.txt"
    path.write_text("hello")
    with pytest.raises(ValueError, match="neither a torch.save archive"):
        ck.load_checkpoint(str(path))


def test_port_checkpoint_roundtrip(tmp_path):
    """A model file and a resume-state file round-trip bit for bit with
    their metadata; the snapshot is a copy, so an in-place update after it
    does not reach the file."""
    model = SimNet(ModelConfig(dropout=0.0, in_features=16, **KW),
                   device="cpu")
    opt = make_optimizer(model, 1e-3, 1e-4)
    for p in model.parameters():
        p.grad = torch.ones_like(p)
    opt.step()
    snap = ck.host_snapshot({"params": model.state_dict(),
                             "opt_state": opt.state_dict()})
    with torch.no_grad():
        for p in model.parameters():
            p.add_(1.0)
    path = str(tmp_path / "state.ckpt")
    ck.save_checkpoint(path, snap, meta={"epoch": 0, "split": 1})
    assert not os.path.exists(path + ".tmp")
    got, meta = ck.load_checkpoint(path)
    assert meta == {"epoch": 0, "split": 1}
    for k, v in snap["params"].items():
        assert torch.equal(got["params"][k], v)
        assert not torch.equal(got["params"][k], model.state_dict()[k])
    fresh = make_optimizer(model, 1e-3, 1e-4)
    fresh.load_state_dict(got["opt_state"])
    for i, st in opt.state_dict()["state"].items():
        for key, v in st.items():
            assert torch.equal(fresh.state_dict()["state"][i][key], v)


def test_async_checkpointer_order_and_errors(tmp_path):
    """Writes to one path land in submission order (the last wins); a
    failed write re-raises at flush after every queued write is awaited,
    and a second flush returns."""
    path = str(tmp_path / "ck.pt")
    ckpt = ck.AsyncCheckpointer()
    ckpt.save(path, {"w": torch.zeros(4)}, meta={"epoch": 0})
    ckpt.save(path, {"w": torch.arange(4.0)}, meta={"epoch": 1})
    ckpt.flush()
    got, meta = ck.load_checkpoint(path)
    assert meta == {"epoch": 1} and torch.equal(got["w"], torch.arange(4.0))
    ckpt.save(str(tmp_path / "no_dir" / "x.ckpt"), {"w": torch.ones(2)})
    ckpt.save(path, {"w": torch.ones(4)}, meta={"epoch": 2})
    # torch.save reports a missing directory as a RuntimeError
    with pytest.raises((OSError, RuntimeError)):
        ckpt.flush()
    assert ck.load_checkpoint(path)[1] == {"epoch": 2}
    ckpt.flush()


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions}


# the scoring CLIs' one flag of the port's own (cli/__init__.py): the scorer
ARCH_ACTION = (("--arch",), "simnet", None, ("simnet", "pglsum"), None,
               "_StoreAction")


def port_actions(parser):
    """A scoring CLI's actions without ``--arch``, which must be there."""
    acts = _actions(parser)
    assert acts.pop("arch") == ARCH_ACTION
    return acts


@pytest.mark.parametrize("port,jax_cli", [(train_cli, jax_train_cli),
                                          (evaluate_cli, jax_evaluate_cli)],
                         ids=["train", "evaluate"])
def test_cli_parser_matches_jax(port, jax_cli):
    """The port's parser is the JAX CLI's, and for ``evaluate`` also
    ``--arch``."""
    acts = (port_actions if port is evaluate_cli else _actions)(
        port.build_parser())
    assert acts == _actions(jax_cli.build_parser())
    # the card takes every width the JAX package takes: the port's help of
    # the width flags reads as the JAX CLI's
    helps = [{a.dest: a.help for a in p._actions if a.dest in (
        "d_model", "num_heads")} for p in (port.build_parser(),
                                           jax_cli.build_parser())]
    assert helps[0] == helps[1]


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_matches_jax(data_root, jax_params, tmp_path, capsys):
    """Both CLIs from the same JAX-written pretrain.ckpt (--use_model) at
    dropout 0 print F / tau / rho within 1e-5; the port's --metrics and
    --profile_dir write their files."""
    split_file = tmp_path / "splits.json"
    split_file.write_text(json.dumps(SPLITS[:1]))
    outs = {}
    for side, main in (("jax", jax_train_cli.main),
                       ("port", lambda a: train_cli.main(a, device="cpu"))):
        wd = tmp_path / side
        wd.mkdir()
        jax_save_checkpoint(str(wd / "pretrain.ckpt"), jax_params)
        argv = ["--data", data_root, "--d_model", "32", "--num_heads", "4",
                "--num_layers", "1", "--dropout", "0", "--batch_size", "2",
                "--max_epoch", "2", "--split_path", str(split_file),
                "--workdir", str(wd), "--use_model",
                "--metrics", str(wd / "m.jsonl")]
        if side == "port":
            argv += ["--profile_dir", str(wd / "trace"), "--debug_nans"]
        main(argv)
        outs[side] = _last_json(capsys)
    assert outs["port"].keys() == outs["jax"].keys()
    np.testing.assert_allclose(list(outs["port"].values()),
                               list(outs["jax"].values()), rtol=1e-5,
                               atol=1e-5)
    assert len(_records(tmp_path / "port" / "m.jsonl")) == 3
    with open(tmp_path / "port" / "trace" / "trace.json") as f:
        assert "aten::" in f.read()


def test_cli_evaluate_matches_jax(data_root, jax_params, tmp_path, capsys):
    """The JAX CLI and the port's on one JAX-written --ckpt print the same
    JSON within 1e-5; the port's own checkpoint of the same weights and the
    fused-block route (--attn pallas_block) give it too."""
    jpath = str(tmp_path / "m.ckpt")
    jax_save_checkpoint(jpath, jax_params)
    ppath = str(tmp_path / "m_port.ckpt")
    ck.save_checkpoint(ppath, params_from_jax(jax_params))
    base = ["--data", data_root, "--d_model", "32", "--num_heads", "4",
            "--num_layers", "1", "--split_path", None, "--fold", "1"]
    split_file = tmp_path / "splits.json"
    split_file.write_text(json.dumps(SPLITS))
    base[base.index(None)] = str(split_file)
    jax_evaluate_cli.main(base + ["--ckpt", jpath])
    want = _last_json(capsys)
    for extra in (["--ckpt", jpath], ["--ckpt", ppath],
                  ["--ckpt", ppath, "--attn", "pallas_block"]):
        evaluate_cli.main(base + extra, device="cpu")
        got = _last_json(capsys)
        assert got.keys() == want.keys()
        np.testing.assert_allclose(list(got.values()), list(want.values()),
                                   rtol=1e-5, atol=1e-5, err_msg=str(extra))


def test_entry_points_run_on_the_card_only(data_root, tmp_path):
    """Without ``device`` the entry points run on the card and raise where
    there is none; ``--dp`` builds its mesh there too, and a mesh whose
    first entry is not ``device`` is refused."""
    from vidsum_tpu_torch.parallel import make_mesh

    _, conf = _configs(data_root)
    split_file = tmp_path / "splits.json"
    split_file.write_text(json.dumps(SPLITS[:1]))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            train_cli.main(["--data", data_root, "--split_path",
                            str(split_file), "--workdir", str(tmp_path),
                            "--dp"])
    with pytest.raises(ValueError, match="not the mesh's first entry"):
        ft.finetune(conf, SPLITS, workdir=str(tmp_path),
                    mesh=make_mesh((2, 1), "cpu", ("data", "model")),
                    device="meta")
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ft.finetune(conf, SPLITS, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--data", data_root, "--split_path", str(split_file),
                        "--workdir", str(tmp_path)])
    ppath = str(tmp_path / "m.ckpt")
    ck.save_checkpoint(ppath, SimNet(ModelConfig(), device="cpu")
                       .state_dict())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate_cli.main(["--data", data_root, "--ckpt", ppath])


def test_metrics_logger_trace_and_step_timer(tmp_path):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path))
    log.log({"a": 1.5}, step=3)
    log.close()
    rec = _records(path)[0]
    assert rec["a"] == 1.5 and rec["step"] == 3 and rec["ts"] > 0
    with trace(None):
        pass
    assert os.listdir(tmp_path) == ["m.jsonl"]
    with trace(str(tmp_path / "t")):
        torch.ones(8).sum()
    assert os.path.getsize(tmp_path / "t" / "trace.json") > 0
