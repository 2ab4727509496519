"""On the card: at a size a test run holds (fewer batches, rows, clients
and checked requests than the cells, the same lengths and widths), the
system under test keeps within every limit of its cell, and the control,
the plain reference in TF32 products, breaks at least one. Run with
``python -m pytest benchmark/tests/test_bench_cuda.py -q`` on a GPU
machine; it skips without a card."""

import pytest
import torch

from benchmark import calibrate, harness

pytestmark = pytest.mark.cuda

SEEDS = [101, 2**31 + 5, 77_777]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the port's hand-written kernels have "
                    "no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _small(cell: str) -> dict:
    tr = dict(harness.load_traffic(cell))
    if tr["driver"] == "serve_loop":
        tr.update(clients=4, pool_videos=4, sample_checked=6)
    else:
        tr.update(pool_batches=3,
                  batch={"pretrain-b256": 32}.get(cell, 2))
    return tr


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["pretrain-b256", "serve-long",
                                  "finetune-long"])
def test_program_within_limits_control_beyond(cuda, cell, seed):
    spec = harness.load_spec()
    entry = harness.find_cell(spec, cell)
    config = harness.load_config(entry["config"])
    traffic = _small(cell)
    driver = harness.load_driver(traffic["driver"])
    session = driver.Session(config, traffic, seed, "cuda")
    if traffic["driver"] == "serve_loop":
        session.window(2.0, None)
        readings = dict(calibrate._serving(session, control=True))
    else:
        readings = dict(calibrate._training(session, control=True))
    limits = traffic["limits"]
    for name, limit in limits.items():
        assert readings["program"][name] <= limit, (name, readings)
    assert any(readings["control"][name] > limit
               for name, limit in limits.items()
               if name in readings["control"]), readings
