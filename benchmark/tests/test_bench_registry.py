"""A new configuration, cell and per-layer metric join the benchmark as
files alone: a copy of the benchmark gains three files and an entry in its
``BENCHMARK.json``, and a run of the new cell reports the new metric, with
no line of the harness changed."""

import json
import os
import shutil
import subprocess
import sys

from benchmark import harness
from benchmark.tests.conftest import tiny_config, tiny_traffic

NEW_METRIC = '''"""Steps run in the window (a test's metric)."""

UNIT = "steps"


def read(run):
    return run.record["steps"] if run.record["kind"] == "train" else None
'''

DRIVE = '''
import json, sys
from benchmark import harness
spec = harness.load_spec()
cell = harness.find_cell(spec, "tiny-pretrain")
names = [m["name"] for m in harness.cell_metrics(spec, "tiny-pretrain",
                                                 True)]
res = harness.run_cell(harness.load_config(cell["config"]),
                       harness.load_traffic(cell["traffic"]), names, 5, 0.5,
                       True, "cpu", 0.0)
print(json.dumps({"correct": res["correct"], "metrics": res["metrics"],
                  "names": names}))
'''


def test_new_files_make_a_new_cell(tmp_path):
    bench = tmp_path / "benchmark"
    shutil.copytree(harness.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    with open(bench / "configs" / "tiny-simnet.json", "w") as f:
        json.dump(tiny_config("simnet-pretrain-d256"), f)
    traffic = tiny_traffic("pretrain-b256")
    traffic["trace_seconds"] = 0.3
    with open(bench / "workloads" / "tiny-pretrain.json", "w") as f:
        json.dump(traffic, f)
    (bench / "metrics" / "steps_run.train.py").write_text(NEW_METRIC)
    spec = harness.load_spec()
    spec["configs"].append({"name": "tiny-simnet", "source": "test",
                            "file": "benchmark/configs/tiny-simnet.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "tiny-pretrain",
                              "config": "tiny-simnet",
                              "traffic": "tiny-pretrain", "chips": 1,
                              "why": "test"})
    spec["per_layer"].append({"name": "steps_run.train", "unit": "steps",
                              "better": "higher", "source": "host_clock",
                              "layer": "train step",
                              "moves": "train_frames_per_s",
                              "workloads": ["tiny-pretrain"]})
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(spec, f)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(tmp_path), harness.ROOT]), OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", DRIVE], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["names"] == ["steps_run.train"]
    assert res["correct"]
    assert res["metrics"]["steps_run.train"]["value"] >= 1


def test_metric_lists_follow_the_spec():
    spec = harness.load_spec()
    for cell in spec["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                       False)}
        layer = {m["name"] for m in harness.cell_metrics(spec, cell["name"],
                                                         True)}
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        for name in e2e | layer:
            assert os.path.exists(os.path.join(harness.BENCH_DIR, "metrics",
                                               name + ".py"))
        for m in spec["per_layer"]:
            if cell["name"] in m.get("workloads", []):
                assert m["moves"] in e2e
        assert os.path.exists(os.path.join(harness.BENCH_DIR, "workloads",
                                           cell["traffic"] + ".json"))
    for c in spec["configs"]:
        assert os.path.exists(os.path.join(harness.ROOT, c["file"]))
