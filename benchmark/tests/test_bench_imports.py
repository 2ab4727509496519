"""Import hygiene: the modules a run loads include no top-level module named
``jax``, ``jaxlib``, ``flax`` or ``vidsum_tpu`` (compared whole: the port's
``vidsum_tpu_torch`` is not the JAX package), and the plain reference loads
nothing of the port either. Each check runs in a fresh interpreter, since
the test process itself may hold JAX."""

import ast
import glob
import json
import os
import subprocess
import sys
import types

from benchmark import harness

LIST_TOPS = '''
import json, sys
{imports}
print(json.dumps(sorted({{m.split(".", 1)[0] for m in sys.modules}})))
'''


def _tops(imports: str) -> set:
    env = dict(os.environ, PYTHONPATH=harness.ROOT)
    out = subprocess.run([sys.executable, "-c",
                          LIST_TOPS.format(imports=imports)],
                         cwd=harness.ROOT, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_run_loads_no_jax():
    metrics = [os.path.basename(p)[:-3] for p in
               glob.glob(os.path.join(harness.BENCH_DIR, "metrics", "*.py"))]
    imports = "\n".join(
        ["import benchmark.run, benchmark.calibrate, benchmark.trace",
         "from benchmark import harness",
         "harness.load_driver('train_step')",
         "harness.load_driver('serve_loop')"]
        + [f"harness.load_metric({m!r})" for m in metrics])
    tops = _tops(imports)
    assert "vidsum_tpu_torch" in tops and "torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_loads_nothing_of_the_port():
    mods = sorted(os.path.basename(p)[:-3] for p in glob.glob(
        os.path.join(harness.BENCH_DIR, "reference", "*.py"))
        if not p.endswith("__init__.py"))
    tops = _tops("\n".join(f"import benchmark.reference.{m}" for m in mods))
    assert not tops & ({"vidsum_tpu_torch"} | set(harness.FORBIDDEN))
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "reference",
                                       "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                assert name.split(".", 1)[0] not in (
                    {"vidsum_tpu_torch"} | set(harness.FORBIDDEN)), path


def test_forbidden_names_compare_whole(monkeypatch):
    mod = types.ModuleType("stand_in")
    for name in ("vidsum_tpu_torch_extra", "jaxtyping_like"):
        monkeypatch.setitem(sys.modules, name, mod)
    assert not {"vidsum_tpu_torch_extra", "jaxtyping_like"} & set(
        harness.forbidden_modules())
    monkeypatch.setitem(sys.modules, "vidsum_tpu.ops", mod)
    assert "vidsum_tpu" in harness.forbidden_modules()
