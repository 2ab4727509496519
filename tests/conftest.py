"""Registers the marker of tests that need an NVIDIA GPU."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA GPU (the port's hand-written kernels); "
        "skips with a reason where there is none")
