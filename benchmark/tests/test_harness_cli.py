"""run.py refuses to run without a card, and finds a further traffic mix
and a further per-layer metric by name alone."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import common

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def test_run_refuses_without_a_card():
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "walker2d-b8192",
         "--seed", "2147483659", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert r.returncode == 2
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_run_fails_without_the_program(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's
    folder prints no result and exits non-zero."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "walker2d-b8192",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=""))
    assert r.returncode != 0
    assert r.stdout.strip() == ""


def test_a_new_traffic_file_and_reader_are_found_by_name(tmp_path,
                                                        monkeypatch):
    """Temporary copies of the harness's directories with one traffic
    file, one metric reader and one limits file added, and a
    BENCHMARK.json that names them: the cell loads and its reader runs,
    and no existing file was edited."""
    root = tmp_path / "repo"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    before = {p: open(p, "rb").read()
              for p in (root / "benchmark").rglob("*") if p.is_file()}
    tr = json.loads((root / "benchmark/traffic/random-b8192.json")
                    .read_text())
    tr["batch"] = 4096
    (root / "benchmark/traffic/random-b4096.json").write_text(
        json.dumps(tr))
    (root / "benchmark/metrics/env.batch_seen.py").write_text(
        "def read(ctx):\n    return float(ctx.batch)\n")
    (root / "benchmark/limits/walker2d-b4096.json").write_text(
        (root / "benchmark/limits/walker2d-b8192.json").read_text())
    bench["workloads"].append(
        {"name": "walker2d-b4096", "config": "walker2d",
         "traffic": "random-b4096", "chips": 1, "why": "a test cell"})
    for m in bench["end_to_end"]:
        if m["name"] == "env_steps_per_s":
            m["workloads"].append("walker2d-b4096")
    bench["per_layer"].append(
        {"name": "env.batch_seen", "unit": "envs", "better": "higher",
         "source": "program_counter", "layer": "env step",
         "moves": "env_steps_per_s", "workloads": ["walker2d-b4096"]})
    monkeypatch.setattr(common, "ROOT", str(root))
    monkeypatch.setattr(common, "BENCH", str(root / "benchmark"))
    cell = common.Cell("walker2d-b4096", bench=bench)
    assert cell.batch == 4096
    assert "env.batch_seen" in cell.per_layer
    ctx = type("Ctx", (), {"batch": cell.batch})()
    got = common.read_per_layer(
        type("C", (), {"per_layer": {"env.batch_seen":
                                     cell.per_layer["env.batch_seen"]}})(),
        ctx)
    assert got == {"env.batch_seen": {"value": 4096.0, "unit": "envs"}}
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


@pytest.mark.parametrize("name", ["lcp_residual_p99", "k1_substep.roofline",
                                  "device.idle_share", "step_mfu"])
def test_a_reader_with_nothing_to_read_returns_none(name):
    ctx = type("Ctx", (), {"profile": None, "residual": None,
                           "step_s": None, "batch": 1, "config": None})()
    assert common.reader(name)(ctx) is None
