"""PyTorch port, the bench surface (bench/throughput.py): each knob of the
JAX bench CLI reaches the task's model or its warm start, the configs and
the metric line are the JAX CLI's, and `profile_dir` writes a trace with
the engine's named ranges (engine/world.py).  CPU, tiny batches."""
import json
import os

import pytest

from dartenv_tpu.bench import throughput as jax_bench
from dartenv_tpu_torch.bench import throughput as bench

SMALL = ["--device", "cpu", "--batch", "2", "--horizon", "1", "--iters",
         "0"]


@pytest.mark.parametrize("flag,value,key,want", [
    ("--cold", None, "warm_start", False),
    ("--solver", "dantzig", "solver", "dantzig"),
    ("--pgs_iters", "12", "pgs_iters", 12),
    ("--escalate_frac", "0.25", "escalate_frac", 0.25),
    ("--escalate_iters", "6", "escalate_iters", 6),
    ("--escalate_iters2", "5", "escalate_iters2", 5),
    ("--escalate_refine", "1", "escalate_refine", 1),
    ("--escalate_kmax", "256", "escalate_kmax", 256),
    ("--escalate_ref64", "1", "escalate_ref64", 1),
    ("--escalate_ref", "2", "escalate_ref", 2),
])
def test_each_knob_reaches_the_task(flag, value, key, want):
    """One hopper control step at B = 2 on the CPU with one flag: the
    detailed line reads the flag's value back from task.model.solver (or
    task.warm_start), and the run ends with a rate."""
    argv = ["--env", "hopper", flag] + ([value] if value else []) + SMALL
    (detail, line), = bench.main(argv)
    got = (detail[key] if key == "warm_start"
           else detail["solver_config"][key])
    assert got == want
    if flag != "--cold":
        assert detail["warm_start"] is True
    assert line["value"] > 0 and detail["control_steps_run"] == 1


def test_kmax_sets_the_escalated_batch():
    """K = min(B, kmax, ceil(frac B)): --escalate_kmax caps it and
    --escalate_frac sets it (the bench's escalation_k)."""
    (d, _), = bench.main(["--env", "hopper", "--escalate_frac", "1.0",
                          "--escalate_kmax", "3", "--device", "cpu",
                          "--batch", "5", "--horizon", "1", "--iters", "0"])
    assert d["escalation_k"] == 3


def test_dr_xla_is_the_phasewise_route():
    """--dr_xla (the JAX flag) is --dr_phasewise: bench_dr's phase-wise
    route; the metric line names the route."""
    for flag, kernel in (("--dr_xla", False), ("--dr_phasewise", False),
                         ("--dr", True)):
        (d, line), = bench.main(["--env", "hopper", flag, "--substeps", "1",
                                 "--device", "cpu", "--batch", "2",
                                 "--iters", "0"])
        assert d["kernel_path"] is kernel
        assert line["metric"].endswith(
            "kernel)" if kernel else "phasewise)")


def test_configs_equal_the_jax_bench():
    assert bench.BASELINE_CONFIGS == jax_bench.BASELINE_CONFIGS
    assert (bench.REFERENCE_CPU_STEPS_PER_S
            == jax_bench.REFERENCE_CPU_STEPS_PER_S)


def _jax_lines(monkeypatch, argv):
    """The JAX CLI's metric lines for `argv`, its bench functions replaced
    by a fixed rate (the lines are what is compared, not the JAX run)."""
    monkeypatch.setattr(jax_bench, "enable_compile_cache", lambda: None)
    monkeypatch.setattr(jax_bench, "bench_env", lambda *a, **k: {
        "env_steps_per_s_per_chip": 12345.67})
    monkeypatch.setattr(jax_bench, "bench_dr", lambda *a, **k: {
        "env_steps_per_s_per_chip": 12345.67, "kernel_path": True})
    out = jax_bench.main(argv)
    return out if isinstance(out, list) else [out]


def test_metric_line_is_the_jax_clis(monkeypatch):
    """The metric line after a real one-step run (--horizon 1): the JAX
    CLI's keys, with `card` beside them, and its metric string; its value
    and vs_baseline are the run's rate, rounded as the JAX CLI rounds."""
    (detail, line), = bench.main(["--env", "hopper", "--horizon", "1",
                                  "--batch", "2", "--iters", "0",
                                  "--device", "cpu"])
    jline, = _jax_lines(monkeypatch, ["--env", "hopper", "--horizon", "1",
                                      "--batch", "2"])
    assert set(line) == set(jline) | {"card"} and line["card"] == "cpu"
    assert line["metric"] == jline["metric"]
    assert line["unit"] == jline["unit"]
    rate = detail["env_steps_per_s_per_chip"]
    assert line["value"] == round(rate, 1)
    assert line["vs_baseline"] == round(
        rate / jax_bench.REFERENCE_CPU_STEPS_PER_S, 2)
    # the DR line, kernel route
    (_, dline), = bench.main(["--env", "hopper", "--dr", "--substeps", "1",
                              "--batch", "2", "--iters", "0", "--device",
                              "cpu"])
    jd, = _jax_lines(monkeypatch, ["--env", "hopper", "--dr", "--batch",
                                   "2"])
    assert dline["metric"] == jd["metric"]


def test_all_prints_five_jax_metric_lines(monkeypatch, capsys):
    """--all: one detailed line and one metric line per BASELINE_CONFIGS
    entry, metric strings equal to the JAX CLI's --all (bench_env replaced
    by a fixed result: the five full-size configs are a card's work)."""
    seen = []

    def fake(env, batch, horizon, iters, **kw):
        seen.append((env, batch, horizon, iters, kw["warm_start"]))
        return {"env_steps_per_s_per_chip": 1000.0 * len(seen)}

    monkeypatch.setattr(bench, "bench_env", fake)
    runs = bench.main(["--all", "--horizon", "10", "--iters", "1",
                       "--cold", "--device", "cpu"])
    assert seen == [(e, b, 10, 1, False)
                    for e, b, _ in bench.BASELINE_CONFIGS]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
               if ln.startswith("{")]
    lines = [p for p in printed if "metric" in p]
    assert len(runs) == len(lines) == 5 and len(printed) == 10
    jlines = _jax_lines(monkeypatch, ["--all"])
    assert [ln["metric"] for ln in lines] == [j["metric"] for j in jlines]
    assert all(ln["card"] == "cpu" for ln in lines)


@pytest.mark.parametrize("env,ranges", [
    ("hopper", ("substep_fused",)),
    ("cartpole", ("dynamics", "collision", "constraints", "integrate")),
])
def test_profile_dir_trace_holds_the_named_ranges(tmp_path, env, ranges):
    """bench_env(profile_dir=) on the CPU writes a Chrome trace of one
    rollout that holds the engine's ranges: the fused phase (hopper), the
    four phase-wise stages (cartpole)."""
    out = bench.bench_env(env, batch=2, horizon=1, iters=0, device="cpu",
                          profile_dir=str(tmp_path))
    path = out["profile_trace"]
    assert os.path.dirname(path) == str(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events
             if e.get("cat") == "user_annotation"}
    assert set(ranges) <= names, names
    assert out["control_steps_run"] == 2      # warm-up, profiled rollout
