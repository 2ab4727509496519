"""The readings the limits of ``correct`` are set from, on the card, at a
cell's own sizes: over many seeds in one process, the numbers the check
compares for the system under test, for the control (the plain reference in
the precision below the configuration's: TF32 products for float32) and,
for training cells, for the planted fault "half of the batch left out" (the
reference trained on the first half of each batch).

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        --control-seeds 3 [--seconds 3] [--out FILE]

Training cells run no window (the check follows the set-up's first three
steps); serving cells run a short window at the cell's load so that the
sample holds as many requests as a run's. One JSON line per seed and
reading goes to standard output and to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from benchmark import harness
from benchmark.reference import compare


def _training(session, control: bool) -> list:
    prog = session.first
    session.release()
    ref = session.follow()
    sides = [("program", prog)]
    if control:
        sides += [("control", session.follow(tf32=True)),
                  ("half_batch", session.follow(half=True))]
    return [(who, dict(compare.training(got, ref),
                       details=compare.training_readings(got, ref)))
            for who, got in sides]


def _serving(session, control: bool) -> list:
    session.release()
    idx = session.sample()
    ref = {i: session.reference_scores(i) for i in idx}
    gap = lambda got: compare.worst(  # noqa: E731
        float(np.abs(got[i] - ref[i]).max()) for i in idx)
    out = [("program", {
        "scores": gap({i: session.results[i][4].scores for i in idx}),
        "summaries": sum(session.summary_wrong(i) for i in idx),
        "lost": session.lost, "sampled": len(idx),
        "longest": max(session.results[i][3][2] for i in idx)})]
    if control:
        out.append(("control", {"scores": gap(
            {i: session.reference_scores(i, tf32=True) for i in idx})}))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True,
                   help="comma-separated seeds")
    p.add_argument("--control-seeds", type=int, default=3,
                   help="how many of the seeds also read the control and "
                        "the planted fault")
    p.add_argument("--seconds", type=float, default=3.0,
                   help="serving cells: the short window's length")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    spec = harness.load_spec()
    cell = harness.find_cell(spec, args.workload)
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    driver = harness.load_driver(traffic["driver"])
    sink = open(args.out, "a") if args.out else None
    try:
        for n, seed in enumerate(int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            session = driver.Session(config, traffic, seed, "cuda")
            setup_s = time.perf_counter() - t0
            control = n < args.control_seeds
            if traffic["driver"] == "serve_loop":
                session.window(args.seconds, None)
                readings = _serving(session, control)
            else:
                readings = _training(session, control)
            for who, numbers in readings:
                line = json.dumps({"cell": cell["name"], "seed": seed,
                                   "who": who, "numbers": numbers,
                                   "setup_s": setup_s,
                                   "s": time.perf_counter() - t0})
                print(line, flush=True)
                if sink:
                    sink.write(line + "\n")
            del session
            torch.cuda.empty_cache()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
