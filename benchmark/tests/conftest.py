"""Shared fixtures of the benchmark's own tests: tiny versions of the
cells' configurations and traffic, which the CPU runs in seconds."""

import pytest
import torch

from benchmark import harness


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's hand-written kernels)")


def tiny_config(name: str) -> dict:
    cfg = dict(harness.load_config(name))
    cfg.update(in_features=64, d_model=32, num_heads=2, num_layers=2)
    return cfg


def tiny_traffic(name: str) -> dict:
    tr = dict(harness.load_traffic(name))
    tr["trace_seconds"] = 0.5
    if tr["driver"] == "serve_loop":
        tr.update(lengths={"dist": "log_uniform", "low": 100, "high": 600,
                           "count": 8},
                  clients=3, pool_videos=2, sample_checked=5)
        tr["service"] = dict(tr["service"], max_batch=4)
    else:
        tr.update(batch=4, pool_batches=4,
                  lengths={"dist": "uniform", "low": 60, "high": 250})
        if tr["route"] == "flash":
            tr["attn_impl"] = "flash"
    return tr


@pytest.fixture(autouse=True)
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)
