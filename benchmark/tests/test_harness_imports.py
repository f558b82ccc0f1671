"""The harness loads its cells and runs each driver on the CPU without
loading JAX or the JAX package, and the reference imports nothing of
JAX, the JAX package or the program."""
import ast
import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import common

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
BANNED = {"jax", "jaxlib", "flax", "dartenv_tpu"}


def top_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


def reference_files():
    files = [os.path.join(BENCH, "reference", f)
             for f in os.listdir(os.path.join(BENCH, "reference"))
             if f.endswith(".py")]
    files += [os.path.join(BENCH, "configs", f)
              for f in os.listdir(os.path.join(BENCH, "configs"))
              if f.endswith(".py") and f != "__init__.py"]
    return files


@pytest.mark.parametrize("path", reference_files(),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_reference_imports_neither_jax_nor_the_program(path):
    bad = top_imports(path) & (BANNED | {"dartenv_tpu_torch"})
    assert not bad, f"{path} imports {bad}"


def test_every_cell_loads():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        cell = common.Cell(w["name"])
        assert cell.per_layer and cell.limits
        assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
        for name in cell.per_layer:
            assert callable(common.reader(name))


def test_dry_runs_load_no_jax():
    """Each driver, cut to a tiny batch on the CPU, in a fresh process;
    then no loaded module's top-level name is JAX's or the JAX
    package's (the port's own name starts with the latter's, and is
    allowed)."""
    code = (
        "import sys, json\n"
        "from benchmark.tests.conftest import tiny_run\n"
        "for w, b in (('walker2d-b8192', 8), ('walker2d-push-b8192', 8),"
        " ('walker2d-gym-b1', None)):\n"
        "    out = tiny_run(w, batch=b, samples=1)\n"
        "    assert out['correct'], (w, out['checks'])\n"
        "print(json.dumps(sorted({k.split('.')[0] for k in sys.modules})))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    mods = set(json.loads(r.stdout.strip().splitlines()[-1]))
    assert "dartenv_tpu_torch" in mods
    assert not mods & BANNED, mods & BANNED
