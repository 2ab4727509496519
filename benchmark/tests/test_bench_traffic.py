"""Traffic pools: deterministic in ``--seed``, within each cell's
parameters, and the same set of sizes for every seed."""

import numpy as np
import pytest

from benchmark import harness
from benchmark.drivers import serve_loop, train_step
from benchmark.tests.conftest import tiny_config, tiny_traffic

SEEDS = (7, 2**31 + 99)


@pytest.mark.parametrize("cell", ["pretrain-b256", "finetune-long",
                                  "finetune-recipe"])
def test_cell_length_sets(cell):
    # the cells' own parameters, without building any batch
    tr = harness.load_traffic(cell)
    groups = train_step.batch_groups(tr)
    assert len(groups) == tr["pool_batches"]
    lens = np.concatenate(groups)
    assert lens.min() >= tr["lengths"]["low"]
    assert lens.max() <= tr["lengths"]["high"]
    assert all(len(g) == tr["batch"] for g in groups)
    if cell == "finetune-long":
        # every bucket lies past the fused block's training envelope
        # (N > 7,936 at d 256), so the cell trains on the flash route
        assert lens.min() > 7936
    if cell == "pretrain-b256":
        buckets = {-(-int(g.max()) // tr["bucket"]) * tr["bucket"]
                   for g in groups}
        assert buckets == {384}


@pytest.mark.parametrize("cell", ["pretrain-b256", "finetune-long"])
def test_training_pool_is_deterministic(cell):
    cfg, tr = tiny_config(harness.find_cell(harness.load_spec(), cell)
                          ["config"]), tiny_traffic(cell)
    a = train_step.make_pool(cfg, tr, SEEDS[0], "cpu")
    b = train_step.make_pool(cfg, tr, SEEDS[0], "cpu")
    c = train_step.make_pool(cfg, tr, SEEDS[1], "cpu")
    for x, y in zip(a, b):
        for k in ("x", "y", "mask", "lengths"):
            np.testing.assert_array_equal(getattr(x, k), getattr(y, k))
    assert any(not np.array_equal(x.x, z.x) for x, z in zip(a, c))
    # another seed: the same lengths, in another order
    assert sorted(np.concatenate([p.lengths for p in a])) == sorted(
        np.concatenate([p.lengths for p in c]))
    for p in a:
        B, N, F = p.x.shape
        assert N % tr["bucket"] == 0 and F == cfg["in_features"]
        assert (~p.mask).sum(axis=1).tolist() == p.lengths.tolist()
        assert np.all(p.x[p.mask] == tr["pad_value"])
        assert np.all(p.x[~p.mask] != tr["pad_value"])
        if tr["step"] == "pretrain":
            assert p.y.shape == (B, 512)
        else:
            assert np.all(p.y[p.mask] == tr["pad_value"])
            assert np.all((p.y[~p.mask] >= 0) & (p.y[~p.mask] < 1))


def test_stratified_lengths():
    spec = {"dist": "log_uniform", "low": 2400, "high": 14400}
    lens = train_step.stratified_lengths(spec, 64)
    assert lens.min() >= 2400 and lens.max() <= 14400
    assert np.all(np.diff(lens) > 0)
    mean = float(np.mean(train_step.stratified_lengths(spec, 10_000)))
    # log-uniform mean (hi - lo) / ln(hi / lo)
    assert mean == pytest.approx(12000 / np.log(6), rel=1e-3)


def test_change_points_cover_the_video():
    rng = np.random.default_rng(0)
    cps = serve_loop.change_points(15 * 1000, 40, rng)
    assert cps.shape == (40, 2)
    assert cps[0, 0] == 0 and cps[-1, 1] == 15 * 1000 - 1
    np.testing.assert_array_equal(cps[1:, 0], cps[:-1, 1] + 1)
    assert np.all(cps[:, 1] >= cps[:, 0])


def test_serving_requests_are_deterministic():
    cfg, tr = tiny_config("simnet-d256"), tiny_traffic("serve-long")
    sessions = []
    for seed in (SEEDS[0], SEEDS[0], SEEDS[1]):
        s = serve_loop.Session(cfg, tr, seed, "cpu")
        s.svc.close()
        sessions.append(s)
    a, b, c = sessions
    for client in range(tr["clients"]):
        for k in range(12):
            ra, rb = a.request(client, k), b.request(client, k)
            np.testing.assert_array_equal(ra[0], rb[0])
            np.testing.assert_array_equal(ra[3], rb[3])
            n = ra[0].shape[0]
            assert tr["lengths"]["low"] <= n <= tr["lengths"]["high"]
            np.testing.assert_array_equal(
                ra[1], np.arange(n) * tr["frame_stride"])
            assert ra[2] == n * tr["frame_stride"]
    # every client cycles through the same set of lengths
    got = sorted(c.request(0, k)[0].shape[0]
                 for k in range(tr["lengths"]["count"]))
    assert got == sorted(a.lengths.tolist())
    assert any(not np.array_equal(a.request(0, k)[0], c.request(0, k)[0])
               for k in range(4))
