# ported from vidsum_tpu/native/build.py
"""Build the port's copy of the host eval runtime:
``python -m vidsum_tpu_torch.native.build``.

Compiles ``src/eval_runtime.cc`` with g++ into
``vidsum_tpu_torch/_build/libvidsum_native_<digest>.so`` (the digest hashes
the source and flags, so an edited source is rebuilt). The library exposes a
plain C ABI consumed through ctypes in ``vidsum_tpu_torch/native/__init__.py``;
the JAX package's own library is never loaded.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(HERE, "src", "eval_runtime.cc")
BUILD_DIR = os.path.join(os.path.dirname(HERE), "_build")
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")


def lib_path() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    with open(SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvidsum_native_{h.hexdigest()[:16]}.so")


def build(verbose: bool = True) -> str:
    out = lib_path()
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = ["g++", *FLAGS, "-o", tmp, SRC]
    if verbose:
        print(" ".join(cmd))
    try:
        subprocess.run(cmd, check=True)
        os.replace(tmp, out)   # atomic: a concurrent build never sees a
    finally:                   # half-written library
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


if __name__ == "__main__":
    print(f"built {build()}")
    sys.exit(0)
