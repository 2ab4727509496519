"""Run one benchmark cell of ``vidsum_tpu_torch`` on one CUDA card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. The cell, its configuration and its traffic
are found by name (``BENCHMARK.json``, ``benchmark/configs/``,
``benchmark/workloads/``). The last line of standard output is the result
object; the checks that decide ``correct`` are also the last lines of
standard error. Without a CUDA card, or with JAX or the JAX package loaded
once the window has closed, it prints no result and exits non-zero.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import harness

    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA card: the benchmark runs only on the GPU",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{cell['name']} needs {cell['chips']} cards, "
              f"{torch.cuda.device_count()} found", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    names = [m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                     bool(args.trace))]
    result = harness.run_cell(config, traffic, names, args.seed,
                              args.seconds, bool(args.trace), "cuda",
                              T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
