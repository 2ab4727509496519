"""The frozen plain reference against ``vidsum_tpu_torch``'s CPU path at a
tiny size. The reference imports nothing of the port; this test imports
both to hold them together."""

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import hashes, objectives, summary
from benchmark.reference import simnet as ref
from benchmark.tests.conftest import tiny_config
from vidsum_tpu_torch.models.simnet import SimNet
from vidsum_tpu_torch.ops import attention_train, block_train
from vidsum_tpu_torch.ops import knapsack as port_knapsack
from vidsum_tpu_torch.ops import losses as port_losses
from vidsum_tpu_torch.ops.summary import generate_summary
from vidsum_tpu_torch.train.schedule import reference_pretrain_schedule


def _port_model(cfg, weights):
    from benchmark.drivers.train_step import model_config
    model = SimNet(model_config(cfg), device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return model


def test_hash_bits_equal_the_port():
    ar = torch.arange
    b, r, c = ar(3)[:, None, None], ar(40)[None, :, None], ar(50)[None, None]
    for seed, site, rate in ((5, 33, 0.3), (2**31 - 2, 1, 0.2)):
        np.testing.assert_array_equal(
            hashes.block_keep(seed, torch.tensor(site), b, r, c, rate),
            block_train._keep_bits(seed, torch.tensor(site), b, r, c, rate))
        np.testing.assert_array_equal(
            hashes.attention_keep(seed, b, torch.tensor(site), r, c, rate),
            attention_train._keep_hash(seed, b, torch.tensor(site), r, c,
                                       rate))
    assert hashes.keep_scale(0.3) == block_train._keep_scale(0.3)


def test_eval_forward_matches_the_port():
    cfg = tiny_config("simnet-d256")
    w = harness.make_weights(cfg, 3, "cpu")
    x = torch.randn(2, 200, cfg["in_features"])
    pad = torch.zeros(2, 200, dtype=torch.bool)
    pad[1, 150:] = True
    x[pad] = 1000.0
    got, _ = _port_model(cfg, w)(x, pad, attn_impl="dense")
    want, _ = ref.forward(w, cfg, x, pad)
    keep = ~pad
    torch.testing.assert_close(want[keep], got[..., 0][keep], atol=1e-5,
                               rtol=1e-5)


def test_blocked_attention_and_its_gradient():
    torch.manual_seed(0)
    q, k, v = (torch.randn(2, 2, 300, 8, requires_grad=True)
               for _ in range(3))
    pad = torch.zeros(2, 300, dtype=torch.bool)
    pad[0, 250:] = True
    was = ref.BLOCK_ELEMS
    ref.BLOCK_ELEMS = 2 * 2 * 300 * 37   # 37-row blocks, a ragged last one
    try:
        keep = lambda r0, rows: (  # noqa: E731
            hashes.attention_keep(9, torch.arange(2)[:, None, None, None],
                                  torch.arange(2)[None, :, None, None],
                                  torch.arange(r0, r0 + rows)[None, None, :,
                                                              None],
                                  torch.arange(300)[None, None, None],
                                  0.3), hashes.keep_scale(0.3))
        out = ref.attention(q, k, v, pad, 0.5, keep)
    finally:
        ref.BLOCK_ELEMS = was
    mask, f = keep(0, 300)
    s = (q @ k.transpose(-1, -2) * 0.5).masked_fill(pad[:, None, None],
                                                     float("-inf"))
    dense = torch.where(mask, torch.softmax(s, -1) * f, 0.0) @ v
    torch.testing.assert_close(out, dense)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, (q, k, v), g)
    want = torch.autograd.grad(dense, (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-5, rtol=1e-5)


def test_objectives_match_the_port():
    torch.manual_seed(1)
    B, N, d = 3, 40, 16
    pad = torch.zeros(B, N, dtype=torch.bool)
    pad[0, 30:] = True
    pad[2, 12:] = True
    scores = torch.randn(B, N)
    target = torch.rand(B, N)
    torch.testing.assert_close(
        objectives.masked_mse(scores, target, pad),
        port_losses.mse_with_mask_loss(scores[..., None], target, pad))
    hidden = torch.randn(B, N, d)
    vt = torch.nn.Linear(d, 512)
    rep = torch.randn(B, 512)
    main, center, repel = objectives.pretrain_losses(
        scores, hidden, rep, pad, vt.weight, vt.bias, 0.4)
    from vidsum_tpu_torch.config import ModelConfig, PretrainConfig
    from vidsum_tpu_torch.models.pretrain import PretrainModel
    pm = PretrainModel(ModelConfig(d_model=d, num_heads=2, num_layers=1,
                                   in_features=8), PretrainConfig(),
                       device="cpu")
    with torch.no_grad():
        pm.video_transform.weight.copy_(vt.weight)
        pm.video_transform.bias.copy_(vt.bias)
    want = pm.objective(scores[..., None], hidden, rep, pad)
    for a, b in zip((main, center, repel), want):
        torch.testing.assert_close(a, b)


def test_schedule_matches_the_port():
    sched = reference_pretrain_schedule(1e-3, 50, 50, 200)
    for count in (0, 1, 2, 7, 2500, 2501, 9999):
        assert objectives.pretrain_lr(count, 1e-3, 50, 50, 200) == \
            pytest.approx(sched(count), rel=1e-12)


def test_adam_matches_torch():
    torch.manual_seed(2)
    p = {"a": torch.randn(5, 3), "b": torch.randn(7)}
    q = {k: v.clone().requires_grad_() for k, v in p.items()}
    opt = torch.optim.Adam(list(q.values()), lr=1e-3, weight_decay=1e-4)
    mine = objectives.Adam(p, 1e-4)
    for lr in (1e-3, 0.0, 4e-7):
        grads = {k: torch.randn_like(v) for k, v in p.items()}
        for k, v in q.items():
            v.grad = grads[k].clone()
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        mine.step(p, grads, lr)
    for k in p:
        torch.testing.assert_close(p[k], q[k].detach(), atol=1e-7, rtol=1e-6)


def test_summary_matches_the_port():
    rng = np.random.default_rng(4)
    for n in (40, 300, 1000):
        n_frames = 15 * n
        cuts = np.sort(rng.choice(np.arange(1, n_frames), size=n // 25 + 1,
                                  replace=False))
        cps = np.stack([np.concatenate([[0], cuts]),
                        np.concatenate([cuts - 1, [n_frames - 1]])], 1)
        scores = rng.random(n).astype(np.float32)
        picks = np.arange(n) * 15
        [want] = generate_summary([cps], [scores], [n_frames], [picks], 0.15)
        got = summary.summary(scores, cps, n_frames, picks, 0.15)
        np.testing.assert_array_equal(got, want)


def test_knapsack_matches_the_port():
    rng = np.random.default_rng(5)
    for _ in range(20):
        n = int(rng.integers(1, 30))
        w = rng.integers(1, 40, n).tolist()
        v = rng.random(n).round(2).tolist()   # ties happen
        cap = int(rng.integers(0, 200))
        assert summary.knapsack(cap, w, v) == port_knapsack.knapsack(
            cap, w, v, use_native=False)
