"""The benchmark's general part: finding a cell's files by name, seeds,
weights, the device record, and the run itself (set-up, window, check,
metrics) whatever the cell's driver.

A cell in ``BENCHMARK.json`` names a configuration
(``configs/<config>.json``) and a traffic mix (``workloads/<traffic>.json``);
the traffic file names its driver (``drivers/<driver>.py``); each metric is
a reader ``metrics/<name>.py``. Nothing here changes when a later change
adds a cell, configuration, driver or metric as files.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import subprocess
import sys
import time
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmark.reference.simnet import param_shapes
from benchmark.trace import Tracer, breakdown

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "vidsum_tpu")


# ------------------------------------------------------------------ files

def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def find_cell(spec: dict, name: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "configs", name + ".json"))


def load_traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH_DIR, "workloads", name + ".json"))


def load_driver(name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.drivers.{name}")


def load_metric(name: str) -> ModuleType:
    """The reader ``metrics/<name>.py`` (names may hold dots)."""
    path = os.path.join(BENCH_DIR, "metrics", name + ".py")
    mod_name = "benchmark.metrics." + name.replace(".", "__")
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(spec: dict, cell: str, trace: bool) -> List[dict]:
    """The metric entries a run of ``cell`` reports: end-to-end ones with
    ``--trace 0``, per-layer ones with ``--trace 1``; an entry with a
    ``workloads`` list counts only for the cells it names."""
    entries = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell in m["workloads"]]


def load_peaks() -> dict:
    return load_json(os.path.join(BENCH_DIR, "peaks.json"))


# ------------------------------------------------------------ seeds, data

def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one purpose, derived from the run's ``--seed``."""
    words = np.random.SeedSequence(
        [int(seed) & (2**64 - 1), int(seed) >> 64,
         int.from_bytes(tag.encode(), "little")]).generate_state(2, np.uint64)
    return int(words[0]) & (2**63 - 1)


def device_generator(seed: int, tag: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, tag))


def make_weights(cfg: dict, seed: int, device,
                 extra: Optional[Dict[str, tuple]] = None
                 ) -> Dict[str, torch.Tensor]:
    """f32 weights on ``device`` from one uniform draw of a generator there:
    each Linear's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)), the
    LayerNorms ones and zeros. ``extra`` adds Linear layers (name ->
    weight shape) after the scorer's."""
    shapes = dict(param_shapes(cfg))
    for name, shape in (extra or {}).items():
        shapes[name + ".weight"] = shape
        shapes[name + ".bias"] = shape[:1]
    total = sum(int(np.prod(s)) for s in shapes.values())
    gen = device_generator(seed, "weights", device)
    flat = torch.rand(total, generator=gen, device=device) * 2 - 1
    out, off, fan_in = {}, 0, {}
    for name, shape in shapes.items():
        size = int(np.prod(shape))
        part = flat[off:off + size].view(shape)
        off += size
        base = name.rsplit(".", 1)[0]
        if ".norm" in name:
            out[name] = (torch.ones(shape, device=device)
                         if name.endswith("weight")
                         else torch.zeros(shape, device=device))
            continue
        if name.endswith("weight"):
            fan_in[base] = shape[1]
        out[name] = (part * fan_in[base] ** -0.5).contiguous()
    return out


def load_weights(model: torch.nn.Module, weights: Dict[str, torch.Tensor]
                 ) -> None:
    """Copy ``weights`` into the port's model by parameter name; a name
    under the pretraining model's ``encoder.`` is the scorer's name."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            key = name if name in weights else name.split(".", 1)[1]
            p.copy_(weights[key])


# ------------------------------------------------------------------ device

def device_record(device) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": 1,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=20)
        rec["power_limit"] = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        rec["power_limit"] = "not read"
    return rec


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# --------------------------------------------------------------------- run

class Run:
    """What a cell's metric readers read: the configuration, the traffic,
    the driver's record of the window, the reduced trace (``--trace 1``),
    the set-up seconds and the table of peaks."""

    def __init__(self, config: dict, traffic: dict, record: dict,
                 trace: Optional[dict], setup_s: float):
        self.config, self.traffic = config, traffic
        self.record, self.trace = record, trace
        self.setup_s = setup_s
        self.peaks = load_peaks()


def run_cell(config: dict, traffic: dict, metric_names: List[str],
             seed: int, seconds: float, trace: bool, device,
             t_start: float) -> dict:
    """One run of a cell: set-up, the measured window (traced over its first
    ``traffic["trace_seconds"]`` with ``trace``), the check against the
    plain reference, then the metrics. Returns the result object; its
    ``checks`` key comes last."""
    driver = load_driver(traffic["driver"])
    session = driver.Session(config, traffic, seed, device)
    setup_s = time.perf_counter() - t_start
    tracer = Tracer(traffic["trace_seconds"]) if trace else None
    if tracer is not None:
        tracer.prepare()
    record = session.window(seconds, tracer)
    if tracer is not None:
        tracer.stop()
    dev_rec = device_record(device)
    checks = session.check()
    run = Run(config, traffic, record, tracer.summary if tracer else None,
              setup_s)
    metrics = {}
    for name in metric_names:
        reader = load_metric(name)
        value = reader.read(run)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": reader.UNIT}
    result = {"correct": all(c["value"] <= c["limit"]
                             for c in checks.values()),
              "attempted": int(record["attempted"]),
              "failed": int(record["failed"]),
              "metrics": metrics, "device": dev_rec}
    if tracer is not None and tracer.summary is not None:
        result["device"]["busy_s"] = tracer.summary["busy_s"]
        result["device"]["window_s"] = tracer.summary["window_s"]
        result["breakdown"] = breakdown(tracer.summary)
    result["checks"] = checks
    return result
