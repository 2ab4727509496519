"""The port's multi-process runs (``vidsum_tpu_torch/parallel/
distributed.py``) on the CPU under gloo, against the JAX package's
single-process rules and the port's own one-process run.

Two processes, each holding a 2-entry data mesh of the CPU
(``global_mesh(MeshConfig(data=4), ["cpu", "cpu"])``), run ``finetune``
over the same folds from the same JAX-written ``pretrain.ckpt``; the
result, the per-epoch records and the final parameters must equal the
one-process 4-entry run's bit for bit (the shards' gradients sum as one
pairwise tree either way), only the coordinator writes files, and a
coordinator killed after its first state file followed by a two-process
resume must give the bits of the uninterrupted two-process run. The worker
is this file run as a script (its ``__main__`` block); the JAX package is
imported inside the tests only, so a worker starts without it."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from vidsum_tpu_torch.config import (
    Config, DataConfig, MeshConfig, ModelConfig, TrainConfig,
)
from vidsum_tpu_torch.parallel import distributed as dist_mod
from vidsum_tpu_torch.parallel.distributed import (
    DistributedConfig, all_reduce, global_mesh, init_distributed,
    is_coordinator, pick_backend, put_batch,
)
from vidsum_tpu_torch.train import finetune as ft
from vidsum_tpu_torch.train.checkpoint import load_model_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KW = dict(d_model=32, num_heads=4, num_layers=1, dropout=0.3, max_len=256)
SPLITS = [{"train_keys": [f"x.h5/video_{i}" for i in range(6)],
           "test_keys": ["x.h5/video_6", "x.h5/video_7"]}]
TIMEOUT = 300


def _config(data_root: str, max_epoch: int) -> Config:
    return Config(model=ModelConfig(**KW),
                  data=DataConfig(root=data_root),
                  train=TrainConfig(lr=1e-3, weight_decay=1e-4,
                                    batch_size=4, max_epoch=max_epoch,
                                    use_pretrained=True))


def _run(out_dir: str, data_root: str, max_epoch: int, mesh,
         resume: bool = False):
    return ft.finetune(_config(data_root, max_epoch), SPLITS,
                       workdir=out_dir, export_summary=False,
                       metrics_path=os.path.join(out_dir, "metrics.jsonl"),
                       mesh=mesh, resume=resume)


def _worker(argv) -> None:
    """One process of a two-process run: ``pid nproc port data_root out_dir
    max_epoch resume kill_after``. With ``kill_after`` k > 0 the
    coordinator hard-exits (``os._exit(137)``, no shutdown) right after its
    k-th ``train_state.ckpt`` is on disk."""
    pid, nproc, port, data_root, out_dir = argv[:5]
    max_epoch, resume, kill_after = int(argv[5]), argv[6] == "1", int(argv[7])
    torch.set_num_threads(2)
    backend = init_distributed(DistributedConfig(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=int(nproc), process_id=int(pid)))
    assert backend == "gloo", backend
    if kill_after > 0 and is_coordinator():
        from vidsum_tpu_torch.train import checkpoint as ck

        real = ck.AsyncCheckpointer.save
        saves = []

        def save_then_die(self, path, tree, meta=None):
            real(self, path, tree, meta)
            if os.path.basename(path) == "train_state.ckpt":
                saves.append(path)
                if len(saves) >= kill_after:
                    self.flush()          # the file must be on disk first
                    os._exit(137)
        ck.AsyncCheckpointer.save = save_then_die
    mesh = global_mesh(MeshConfig(data=4), ["cpu", "cpu"])
    assert mesh.shape == {"data": 2, "model": 1}
    result = _run(out_dir, data_root, max_epoch, mesh, resume)
    if is_coordinator():
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump({"fscore": result.fscore,
                       "kendall_tau": result.kendall_tau,
                       "spearman_rho": result.spearman_rho}, f)
    torch.distributed.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pair_of_processes(out_dir, data_root, max_epoch, resume="0",
                       kill_after="0", expect_crash=False) -> None:
    port = _free_port()
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (os.environ.get("PYTHONPATH", ""), REPO) if p)}
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), str(pid), "2", str(port),
         data_root, out_dir, str(max_epoch), resume, kill_after],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for pid in range(2)]
    try:
        out0, _ = procs[0].communicate(timeout=TIMEOUT)
        if expect_crash:
            assert procs[0].returncode == 137, out0.decode()[-4000:]
            # the orphaned process fails in its next collective; reap it
            try:
                procs[1].wait(timeout=60)
            except subprocess.TimeoutExpired:
                procs[1].kill()
                procs[1].wait(timeout=30)
            return
        out1, _ = procs[1].communicate(timeout=TIMEOUT)
        for p, out in zip(procs, (out0, out1)):
            assert p.returncode == 0, f"worker failed:\n{out.decode()[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=30)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
    from vidsum_tpu.data.paths import PATH
    from vidsum_tpu.data.synthetic import make_synthetic_h5

    root = tmp_path_factory.mktemp("distdata")
    make_synthetic_h5(str(root / PATH["tvsum"]), n_videos=8, seed=21)
    return str(root)


@pytest.fixture(scope="module")
def pretrained():
    import jax

    from vidsum_tpu.config import ModelConfig as JaxModelConfig
    from vidsum_tpu.models import init_simnet

    return jax.tree_util.tree_map(
        np.asarray, init_simnet(jax.random.PRNGKey(5),
                                JaxModelConfig(**KW)))


def _workdir(parent, name, pretrained) -> str:
    from vidsum_tpu.train import save_checkpoint as jax_save_checkpoint

    d = str(parent / name)
    os.makedirs(d)
    jax_save_checkpoint(os.path.join(d, "pretrain.ckpt"), pretrained)
    return d


@pytest.fixture(scope="module")
def two_process_run(data_root, pretrained, tmp_path_factory):
    """An uninterrupted two-process run of 2 epochs: its workdir."""
    d = _workdir(tmp_path_factory.mktemp("gold"), "two", pretrained)
    _pair_of_processes(d, data_root, 2)
    return d


def _epochs(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    return [(r["epoch"], r["train_loss"], r["val_loss"], r["fscore"])
            for r in recs if "epoch" in r]


def test_init_distributed_single_process_is_noop():
    assert init_distributed(DistributedConfig(num_processes=1)) is None
    assert is_coordinator()
    assert not torch.distributed.is_initialized()
    t = [torch.ones(3)]
    assert all_reduce(t)[0] is t[0]
    with pytest.raises(ValueError, match="coordinator_address"):
        init_distributed(DistributedConfig(num_processes=2))


def test_config_reads_the_jax_environment(monkeypatch):
    from vidsum_tpu.parallel.distributed import (
        DistributedConfig as JaxDistributedConfig,
    )

    monkeypatch.setenv("VIDSUM_COORDINATOR", "10.0.0.1:1234")
    monkeypatch.setenv("VIDSUM_NUM_PROCESSES", "4")
    monkeypatch.setenv("VIDSUM_PROCESS_ID", "3")
    got = DistributedConfig.from_env()
    want = JaxDistributedConfig.from_env()
    assert (got.coordinator_address, got.num_processes, got.process_id) == (
        want.coordinator_address, want.num_processes, want.process_id)


def test_backend_follows_the_placement(monkeypatch):
    cfg = DistributedConfig("127.0.0.1:1", 2, 0)
    assert pick_backend(cfg) == "gloo"          # the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick_backend(cfg) == "gloo"          # two ranks on one card
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert pick_backend(cfg) == "nccl"          # a card each
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pick_backend(DistributedConfig("127.0.0.1:1", 2, 0, (0,))) \
        == "nccl"


def test_put_batch_places_the_process_rows(monkeypatch):
    mesh = global_mesh(MeshConfig(data=4), ["cpu"] * 4)
    x = np.arange(8 * 5 * 3, dtype=np.float32).reshape(8, 5, 3)
    w = np.ones(8, np.float32)
    xs, ws, none = put_batch(mesh, x, w, None)
    assert none is None and len(xs) == 4 and len(ws) == 4
    np.testing.assert_array_equal(torch.cat(xs).numpy(), x)
    # in process 1 of 2, its half of the rows, in shards of its entries
    monkeypatch.setattr(dist_mod, "process_count", lambda: 2)
    monkeypatch.setattr(dist_mod, "process_index", lambda: 1)
    half = global_mesh(MeshConfig(data=4), ["cpu"] * 2)
    assert half.shape == {"data": 2, "model": 1}
    mine = put_batch(half, x)
    assert len(mine) == 2
    np.testing.assert_array_equal(torch.cat(mine).numpy(), x[4:])


def test_two_process_run_matches_one_process(data_root, pretrained,
                                             two_process_run, tmp_path):
    """2 processes x 2 entries against 1 process x 4 entries, dropout 0.3:
    each process sums its shards' grads as the first level of the one
    process's pairwise tree and the all-reduce adds the level above, so the
    result, the records and the final parameters are the same bits; only
    the coordinator wrote files."""
    one = _workdir(tmp_path, "one", pretrained)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)     # the workers' count: the same CPU products
    try:
        base = _run(one, data_root, 2, global_mesh(MeshConfig(data=4),
                                                   ["cpu"] * 4))
    finally:
        torch.set_num_threads(threads)
    two = two_process_run
    with open(os.path.join(two, "result.json")) as f:
        multi = json.load(f)
    assert [multi["fscore"], multi["kendall_tau"], multi["spearman_rho"]] \
        == [base.fscore, base.kendall_tau, base.spearman_rho]
    assert _epochs(os.path.join(two, "metrics.jsonl")) \
        == _epochs(os.path.join(one, "metrics.jsonl"))
    a, _ = load_model_state(os.path.join(one, "model_mae.ckpt"))
    b, _ = load_model_state(os.path.join(two, "model_mae.ckpt"))
    for k, v in a.items():
        assert torch.equal(b[k], v), k
    assert sorted(os.listdir(two)) == sorted(
        ["metrics.jsonl", "model_mae.ckpt", "model_mae.ckpt.meta.json",
         "pretrain.ckpt", "result.json", "train_state.ckpt",
         "train_state.ckpt.meta.json"])


def test_two_process_kill_and_resume_is_exact(data_root, pretrained,
                                              two_process_run, tmp_path):
    """The coordinator dies right after its first state file; both
    processes restart with ``resume=True``: the final parameters, records
    and result are the uninterrupted two-process run's bit for bit."""
    gold = two_process_run
    res = _workdir(tmp_path, "resumed", pretrained)
    _pair_of_processes(res, data_root, 2, kill_after="1", expect_crash=True)
    with open(os.path.join(res, "train_state.ckpt.meta.json")) as f:
        meta = json.load(f)
    assert meta["epoch"] == 0 and meta["split"] == 0
    _pair_of_processes(res, data_root, 2, resume="1")
    a, _ = load_model_state(os.path.join(gold, "model_mae.ckpt"))
    b, _ = load_model_state(os.path.join(res, "model_mae.ckpt"))
    for k, v in a.items():
        assert torch.equal(b[k], v), k
    got = _epochs(os.path.join(res, "metrics.jsonl"))
    assert [e[0] for e in got] == [0, 1]
    assert got == _epochs(os.path.join(gold, "metrics.jsonl"))
    with open(os.path.join(res, "result.json")) as f, \
            open(os.path.join(gold, "result.json")) as g:
        assert json.load(f) == json.load(g)


if __name__ == "__main__":
    _worker(sys.argv[1:])
