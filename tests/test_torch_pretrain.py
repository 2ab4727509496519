"""The port's self-supervised pretraining against the JAX package's, on the
CPU (``device="cpu"``): the three losses and their gradients, the schedule,
the collate and the datasets, the pretraining model's forward and
converters, one step on the fused-block route against the Pallas kernels in
interpret mode, ``pretrain()`` resumed by both packages from one JAX-written
state file, the port's own exact resume, and the pretrain CLI (parser,
``main`` over the ``.npy`` tree and the h5 files, the card-only default)."""

import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vidsum_tpu_torch.models.simnet as simnet_mod
from vidsum_tpu.cli import pretrain as jax_cli
from vidsum_tpu.config import Config as JaxConfig
from vidsum_tpu.config import DataConfig as JaxDataConfig
from vidsum_tpu.config import ModelConfig as JaxModelConfig
from vidsum_tpu.config import PretrainConfig as JaxPretrainConfig
from vidsum_tpu.data import PATH as JAX_PATH
from vidsum_tpu.data import collate as jcollate
from vidsum_tpu.data import datasets as jdatasets
from vidsum_tpu.data.synthetic import make_synthetic_h5
from vidsum_tpu.models.pretrain import init_pretrain_model, pretrain_apply
from vidsum_tpu.models.torch_convert import pretrain_model_from_torch_state
from vidsum_tpu.ops import losses as jlosses
from vidsum_tpu.train import schedule as jschedule
from vidsum_tpu.train import steps as jsteps
from vidsum_tpu.train.pretraining import pretrain as jax_pretrain
from vidsum_tpu_torch.cli import pretrain as cli
from vidsum_tpu_torch.config import (
    Config, DataConfig, ModelConfig, PretrainConfig, pretrain_recipe,
)
from vidsum_tpu_torch.data import collate, datasets
from vidsum_tpu_torch.data.synthetic import make_synthetic_pretrain_tree
from vidsum_tpu_torch.models.convert import (
    load_torch_checkpoint, pretrain_params_from_jax, pretrain_params_to_jax,
)
from vidsum_tpu_torch.models.pretrain import PretrainModel
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import losses
from vidsum_tpu_torch.train import checkpoint as ck
from vidsum_tpu_torch.train import schedule
from vidsum_tpu_torch.train.pretraining import pretrain
from vidsum_tpu_torch.train.steps import make_optimizer, make_pretrain_step

# the CLI builds ModelConfig(in_features=1024), so the data has 1024 features
KW = dict(d_model=32, num_heads=4, num_layers=1)
PT = dict(lr=1e-3, batch_size=2, epochs=2, warmup_epochs=1,
          scheduler_samples=12)
LR = PT["lr"]


@pytest.fixture(scope="module")
def tree_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pt"))
    make_synthetic_pretrain_tree(root, n_videos=6, min_frames=30,
                                 max_frames=60, seed=12)
    return root


def _configs(root, dropout=0.0, **pt):
    pt = {**PT, **pt}
    return (JaxConfig(model=JaxModelConfig(dropout=dropout, **KW),
                      data=JaxDataConfig(root=root),
                      pretrain=JaxPretrainConfig(**pt)),
            Config(model=ModelConfig(dropout=dropout, **KW),
                   data=DataConfig(root=root),
                   pretrain=PretrainConfig(**pt)))


def _pair(dropout, seed=0):
    jcfg = JaxModelConfig(dropout=dropout, **KW)
    params = jax.tree_util.tree_map(
        np.asarray, init_pretrain_model(jax.random.PRNGKey(seed), jcfg))
    model = PretrainModel(ModelConfig(dropout=dropout, **KW), device="cpu")
    model.load_state_dict(pretrain_params_from_jax(params))
    return jcfg, params, model


def _batch(root, idx):
    ds = datasets.PreTrainDataset(root)
    feats, reps = zip(*[ds[i] for i in idx])
    return collate.pad_batch_pretrain(feats, reps)


def _assert_trees_close(got, want, rtol, atol):
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [p for p, _ in flat_g] == list(flat_w)
    for path, leaf in flat_g:
        np.testing.assert_allclose(np.asarray(leaf), np.asarray(flat_w[path]),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("case", ["no_mask", "mask", "zero_rows"])
def test_pretrain_losses_and_grads_match_jax(case):
    """soft_cross_entropy, entropy_centering and repelling_loss (values and
    gradients) against ops/losses.py: without a mask (the padded-width
    denominator), with ragged padding, and with all-zero unpadded rows
    (the safe norm keeps their gradients finite)."""
    rng = np.random.default_rng(3)
    B, N, D = 3, 40, 24
    x = rng.normal(size=(B, N, D)).astype(np.float32)
    mix = rng.dirichlet(np.ones(N), size=B).astype(np.float32)[..., None]
    x1, x2 = (rng.normal(size=(B, 512)).astype(np.float32) for _ in "ab")
    mask = None
    if case != "no_mask":
        mask = np.zeros((B, N), bool)
        mask[0, 30:] = mask[2, 12:] = True
    if case == "zero_rows":
        x[1, 5] = x[1, 17] = 0.0
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.from_numpy(mask)

    def jfns():
        return {"sce": (lambda a, b: jlosses.soft_cross_entropy(a, b),
                        (x1, x2)),
                "center": (lambda m: jlosses.entropy_centering(m, jm), (mix,)),
                "repel": (lambda v: jlosses.repelling_loss(v, jm), (x,))}

    tfns = {"sce": losses.soft_cross_entropy,
            "center": lambda m: losses.entropy_centering(m, tm),
            "repel": lambda v: losses.repelling_loss(v, tm)}
    for name, (jf, args) in jfns().items():
        want, jgrads = jax.value_and_grad(
            jf, argnums=tuple(range(len(args))))(*map(jnp.asarray, args))
        targs = [torch.tensor(a, requires_grad=True) for a in args]
        got = tfns[name](*targs)
        got.backward()
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-5,
                                   atol=1e-6, err_msg=name)
        for t, g in zip(targs, jgrads):
            assert torch.isfinite(t.grad).all(), name
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
    want = jlosses.reference_pad_len(jm, N)
    assert float(losses.reference_pad_len(tm, N)) == float(want)


def test_schedule_matches_jax():
    """The first 2 * steps_per_epoch + 3 rates (through the warm-up into the
    cosine decay: base, 0, then base * scale(k - 1)), and get_scale."""
    spe, warm, epochs = 5, 1, 4
    want = jschedule.reference_pretrain_schedule(LR, spe, warm, epochs)
    got = schedule.reference_pretrain_schedule(LR, spe, warm, epochs)
    counts = range(2 * spe + 3)
    np.testing.assert_allclose([got(k) for k in counts],
                               [float(want(k)) for k in counts], rtol=1e-6)
    assert got(0) == LR and got(1) == 0.0
    for k in range(12):
        assert (schedule.cosine_warmup_scale(k, 4, 11)
                == jschedule.cosine_warmup_scale(k, 4, 11))


def test_collate_and_datasets_match_jax(tree_root, tmp_path):
    """pad_batch_pretrain, make_batches(drop_last=True), PreTrainDataset
    and PreTrainDatasetReady (h5 features + per-key reps) equal JAX's."""
    ds, jds = (datasets.PreTrainDataset(tree_root),
               jdatasets.PreTrainDataset(tree_root))
    assert len(ds) == len(jds) == 6
    for (f, r), (jf, jr) in zip(ds.items, jds.items):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(r, jr)
    feats, reps = zip(*ds.items[:3])
    for got, want in zip(collate.pad_batch_pretrain(feats, reps, bucket=32),
                         jcollate.pad_batch_pretrain(feats, reps, bucket=32)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for n in (10, 12):
        got = list(collate.make_batches(n, 4, shuffle=True, drop_last=True,
                                        rng=np.random.default_rng((1, 2))))
        want = list(jcollate.make_batches(n, 4, shuffle=True, drop_last=True,
                                          rng=np.random.default_rng((1, 2))))
        assert got == want and len(got) == n // 4
    root = str(tmp_path)
    make_synthetic_h5(os.path.join(root, JAX_PATH["tvsum"]), n_videos=3,
                      seed=44)
    os.makedirs(os.path.join(root, "video", "tvsum"))
    for i in range(3):
        np.save(os.path.join(root, "video", "tvsum", f"video_{i}.npy"),
                np.random.default_rng(i).normal(size=512).astype(np.float32))
    got = datasets.PreTrainDatasetReady(root, "tvsum")
    want = jdatasets.PreTrainDatasetReady(root, "tvsum")
    assert len(got) == len(want) == 3
    for (f, r), (jf, jr) in zip(got.items, want.items):
        np.testing.assert_array_equal(f, jf)
        np.testing.assert_array_equal(r, jr)


def test_pretrain_model_forward_matches_jax(tree_root):
    """PretrainModel.forward on the dense route against pretrain_apply
    (xla) at dropout 0, on a padded batch: the three losses within 1e-5."""
    jcfg, params, model = _pair(0.0)
    x, v, mask = _batch(tree_root, [0, 3, 5])
    want = jax.jit(lambda p, a, b, m: pretrain_apply(
        p, jcfg, JaxPretrainConfig(), a, b, m, attn_impl="xla"))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x),
        jnp.asarray(v), jnp.asarray(mask))
    got = model(torch.from_numpy(x), torch.from_numpy(v),
                torch.from_numpy(mask), attn_impl="dense")
    np.testing.assert_allclose([g.item() for g in got],
                               [float(w) for w in want], rtol=1e-5, atol=1e-6)


def _jax_layer_seeds(key, n_layers):
    """The per-layer seeds ``simnet_apply`` draws on the fused-block train
    route (``simnet.py:346-349``)."""
    seeds = []
    for _ in range(n_layers):
        key, sub = jax.random.split(key)
        seeds.append(int(jax.random.randint(sub, (1, 1), 0, 2**31 - 1,
                                            jnp.int32)[0, 0]))
    return seeds


def test_pretrain_step_matches_jax_on_the_fused_block_route(tree_root,
                                                            monkeypatch):
    """One step at dropout 0.2 on the port's fused-block route (plain
    versions on the CPU) against JAX's make_pretrain_step on pallas_block
    (the Pallas train kernels in interpret mode, inside the step's jit),
    with the JAX per-layer seeds as block_seeds: the four losses and every
    parameter after Adam; the frozen video_transform keeps its bits in
    both."""
    jcfg, params, model = _pair(0.2, seed=4)
    x, v, mask = _batch(tree_root, [1, 4])
    pcfg = PretrainConfig(**PT)
    sched_args = (PT["lr"], 6, PT["warmup_epochs"], PT["epochs"])
    jsched = jschedule.reference_pretrain_schedule(*sched_args)
    opt = jsteps.make_optimizer(jsched, pcfg.weight_decay)
    jstep = jsteps.make_pretrain_step(jcfg, JaxPretrainConfig(**PT), opt,
                                      attn_impl="pallas_block")
    key = jax.random.PRNGKey(9)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    new_params, _, jlosses_ = jstep(jp, opt.init(jp), jnp.asarray(x),
                                    jnp.asarray(v), jnp.asarray(mask), key)
    step = make_pretrain_step(model.cfg, pcfg,
                              schedule.reference_pretrain_schedule(
                                  *sched_args),
                              "fused_block", device="cpu")
    optimizer = make_optimizer([("encoder." + n, p) for n, p in
                                model.encoder.named_parameters()], LR,
                               pcfg.weight_decay)
    vt0 = {k: t.clone() for k, t in model.video_transform.state_dict()
           .items()}
    blocks = []
    real = simnet_mod.fused_block_train

    def counting(*args, **kw):
        blocks.append(args[0].shape)
        return real(*args, **kw)

    monkeypatch.setattr(simnet_mod, "fused_block_train", counting)
    got = step(model, optimizer, x, v, mask, torch.Generator(),
               block_seeds=_jax_layer_seeds(key, KW["num_layers"]))
    assert blocks == [(2, 128, KW["d_model"])] * KW["num_layers"]
    np.testing.assert_allclose(got.numpy(), [float(t) for t in jlosses_],
                               rtol=1e-5)
    # Adam's first step moves a parameter by lr * g / (|g| + eps): a near-
    # zero gradient's summation-order difference moves it by a fraction of
    # lr, so the bound is 0.1 lr (tests/test_torch_train.py)
    _assert_trees_close(pretrain_params_to_jax(model.state_dict()),
                        jax.tree_util.tree_map(np.asarray, new_params),
                        rtol=1e-5, atol=0.1 * LR)
    for k, t in model.video_transform.state_dict().items():
        assert torch.equal(t, vt0[k]), k
    np.testing.assert_array_equal(np.asarray(new_params["video_transform"]
                                             ["w"]),
                                  params["video_transform"]["w"])


def test_pretrain_resumed_from_a_jax_state_file_matches_jax(tree_root,
                                                            tmp_path):
    """JAX pretrains one epoch and writes pretrain_state.ckpt; both
    packages resume from that file for epoch 2 (dropout 0): the history and
    every parameter agree within rtol 1e-5 (the JAX Adam state read into
    torch's Adam, the frozen video_transform's moments dropped)."""
    jconf, conf = _configs(tree_root)
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_pretrain(dataclasses_replace_epochs(jconf, 1),
                 jdatasets.PreTrainDataset(tree_root), workdir=jdir)
    shutil.copytree(jdir, pdir)
    assert ck.checkpoint_format(os.path.join(pdir, "pretrain_state.ckpt")) \
        == "flax"
    want = jax_pretrain(jconf, jdatasets.PreTrainDataset(tree_root),
                        workdir=jdir, resume=True)
    got = pretrain(conf, datasets.PreTrainDataset(tree_root), workdir=pdir,
                   resume=True, device="cpu")
    assert len(got["history"]) == len(want["history"]) == 2
    assert got["history"][0] == want["history"][0]
    np.testing.assert_allclose(got["history"], want["history"], rtol=1e-5)
    _assert_trees_close(pretrain_params_to_jax(got["params"]),
                        jax.tree_util.tree_map(np.asarray, want["params"]),
                        rtol=1e-5, atol=1e-7)
    state, meta = ck.load_checkpoint(os.path.join(pdir,
                                                  "pretrain_state.ckpt"))
    assert meta["epoch"] == 1 and len(meta["history"]) == 2
    # the encoder file is a scorer checkpoint
    enc, emeta = ck.load_model_state(os.path.join(pdir, "pretrain.ckpt"))
    SimNet(conf.model, device="cpu").load_state_dict(enc)
    assert emeta == {"epoch": 1}


def dataclasses_replace_epochs(conf, epochs):
    import dataclasses

    return dataclasses.replace(conf, pretrain=dataclasses.replace(
        conf.pretrain, epochs=epochs))


def test_port_resume_is_exact(tree_root, tmp_path):
    """Dropout 0.2: one epoch then a resume to two give the bits of two
    straight epochs (history, parameters, Adam state: the per-epoch
    streams); the frozen video_transform keeps its initial bits."""
    _, conf = _configs(tree_root, dropout=0.2)
    ds = datasets.PreTrainDataset(tree_root)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    straight = pretrain(conf, ds, workdir=a, device="cpu")
    pretrain(dataclasses_replace_epochs(conf, 1), ds, workdir=b,
             device="cpu")
    resumed = pretrain(conf, ds, workdir=b, resume=True, device="cpu")
    assert straight["history"] == resumed["history"]
    assert np.isfinite(straight["history"]).all()
    for k, t in straight["params"].items():
        assert torch.equal(t, resumed["params"][k]), k
    sa, sb = (ck.load_checkpoint(os.path.join(d, "pretrain_state.ckpt"))[0]
              ["opt_state"]["state"] for d in (a, b))
    assert sa.keys() == sb.keys()
    for i in sa:
        for key in sa[i]:
            assert torch.equal(sa[i][key], sb[i][key]), (i, key)
    init = PretrainModel(conf.model, device="cpu",
                         generator=torch.Generator().manual_seed(
                             conf.pretrain.seed))
    for k, t in init.video_transform.state_dict().items():
        assert torch.equal(straight["params"]["video_transform." + k], t)
    assert not torch.equal(straight["params"]["encoder.final_layer.weight"],
                           init.encoder.final_layer.weight)


def _flax_opt_state(params, wd=5e-4):
    jsched = jschedule.reference_pretrain_schedule(LR, 6, 1, 2)
    opt = jsteps.make_optimizer(jsched, wd)
    from flax import serialization

    return serialization.to_state_dict(jax.device_get(opt.init(
        jax.tree_util.tree_map(jnp.asarray, params))))


def test_adam_state_from_jax_maps_and_refuses(tmp_path):
    """count -> step, mu -> exp_avg, nu -> exp_avg_sq through the
    parameters' key mapping (the frozen video_transform's dropped); a tree
    of another shape, a missing moment or a leaf of another shape raises
    ValueError naming it."""
    _, params, model = _pair(0.0)
    tree = _flax_opt_state(params)
    adam = tree["1"]["0"]
    adam["count"] = np.asarray(3, np.int32)
    adam["mu"] = jax.tree_util.tree_map(lambda a: np.full_like(a, 0.25),
                                        adam["mu"])
    opt = make_optimizer([("encoder." + n, p) for n, p in
                          model.encoder.named_parameters()], LR, 5e-4)
    opt.load_state_dict(ck.adam_state_from_jax(tree, pretrain_params_from_jax,
                                               opt))
    state = opt.state_dict()["state"]
    assert len(state) == len(list(model.encoder.parameters()))
    for st, p in zip(state.values(), model.encoder.parameters()):
        assert float(st["step"]) == 3.0
        assert st["exp_avg"].shape == p.shape
        assert torch.all(st["exp_avg"] == 0.25)
        assert torch.all(st["exp_avg_sq"] == 0.0)
    with pytest.raises(ValueError, match="top level"):
        ck.adam_state_from_jax({"0": {}}, pretrain_params_from_jax, opt)
    broken = _flax_opt_state(params)
    del broken["1"]["0"]["mu"]["encoder"]["head"]
    with pytest.raises(ValueError, match="mu is not a parameter tree"):
        ck.adam_state_from_jax(broken, pretrain_params_from_jax, opt)
    broken = _flax_opt_state(params)
    broken["1"]["0"]["nu"]["encoder"]["head"]["w"] = np.zeros((3, 1),
                                                              np.float32)
    with pytest.raises(ValueError,
                       match="nu of encoder.final_layer.weight has shape"):
        ck.adam_state_from_jax(broken, pretrain_params_from_jax, opt)


def test_pretrain_converters_and_a_reference_pth(tmp_path):
    """pretrain_params_from_jax / _to_jax round-trip; a reference-keyed
    pretrain.pth (with its positional-encoding buffer) loads into
    PretrainModel through load_torch_checkpoint, and the JAX package's
    converter reads the same file to the same tree."""
    _, params, model = _pair(0.0, seed=2)
    _assert_trees_close(pretrain_params_to_jax(model.state_dict()), params,
                        rtol=0, atol=0)
    state = dict(model.state_dict())
    state["encoder.embedding_layer.pos_encoder.pe"] = torch.zeros(1, 50, 32)
    path = str(tmp_path / "pretrain.pth")
    torch.save(state, path)
    fresh = PretrainModel(model.cfg, device="cpu")
    fresh.load_state_dict(load_torch_checkpoint(path))
    for k, t in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], t), k
    jtree = pretrain_model_from_torch_state(
        {k: v.numpy() for k, v in state.items()})
    _assert_trees_close(jax.tree_util.tree_map(np.asarray, jtree), params,
                        rtol=0, atol=0)


def _actions(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.choices,
                     a.nargs, type(a).__name__)
            for a in parser._actions}


def test_cli_parser_matches_jax():
    assert _actions(cli.build_parser()) == _actions(jax_cli.build_parser())
    # the card takes every width the JAX package takes: the port's help of
    # the width flags reads as the JAX CLI's
    helps = [{a.dest: a.help for a in p._actions if a.dest in (
        "d_model", "num_heads")} for p in (cli.build_parser(),
                                           jax_cli.build_parser())]
    assert helps[0] == helps[1]
    recipe = pretrain_recipe()
    assert (recipe.model.d_model, recipe.model.dropout,
            recipe.pretrain.batch_size, recipe.pretrain.weight_decay,
            recipe.pretrain.scheduler_samples) == (256, 0.2, 256, 5e-4,
                                                   13000)


@pytest.mark.parametrize("source", ["npy", "h5"])
def test_cli_main_on_the_cpu(tree_root, tmp_path, source):
    """main(..., device="cpu") over the .npy tree and with --from_h5 over
    the DSNet h5 files: the encoder checkpoint and the resume state, a
    finite history, the encoder file loadable as a scorer, and a resume to
    a second epoch from the state file (--debug_nans on)."""
    root = tree_root
    if source == "h5":
        root = str(tmp_path / "h5")
        make_synthetic_h5(os.path.join(root, JAX_PATH["tvsum"]), n_videos=3,
                          seed=55, min_picks=20, max_picks=40)
        os.makedirs(os.path.join(root, "video", "tvsum"))
        for i in range(3):
            np.save(os.path.join(root, "video", "tvsum", f"video_{i}.npy"),
                    np.random.default_rng(i).normal(size=512)
                    .astype(np.float32))
    save = str(tmp_path / "save")
    argv = ["--data", root, "--datasets", "tvsum", "--d_model", "32",
            "--num_heads", "4", "--num_layers", "1", "--batch_size", "2",
            "--epochs", "1", "--save", save, "--debug_nans"]
    if source == "h5":
        argv.append("--from_h5")
    out = cli.main(argv, device="cpu")
    assert len(out["history"]) == 1 and np.isfinite(out["history"]).all()
    enc, meta = ck.load_model_state(os.path.join(save, "pretrain.ckpt"))
    SimNet(ModelConfig(**KW), device="cpu").load_state_dict(enc)
    assert meta == {"epoch": 0}
    argv[argv.index("--epochs") + 1] = "2"
    out = cli.main(argv + ["--resume"], device="cpu")
    assert len(out["history"]) == 2


def test_entry_points_run_on_the_card_only(tree_root, tmp_path):
    """pretrain(mesh=) refuses a batch its data axis does not split (the
    JAX error); without ``device`` pretrain() and the CLI raise where there
    is no card."""
    from vidsum_tpu_torch.parallel import make_mesh

    _, conf = _configs(tree_root)
    ds = datasets.PreTrainDataset(tree_root)
    data = conf.pretrain.batch_size + 1
    with pytest.raises(ValueError, match="not divisible by the data axis"):
        pretrain(conf, ds, workdir=str(tmp_path),
                 mesh=make_mesh((data, 1), "cpu", ("data", "model")))
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        pretrain(conf, ds, workdir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--data", tree_root, "--save", str(tmp_path)])
