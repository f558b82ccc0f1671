"""PyTorch port, the production-width envelope script
(scripts/torch_residual_envelope.py) and its hook
(validation/residual.make_envelope_substep) on the CPU: the JAX script's
records at B = 64 and 8 substeps, and the hook's substep equal to the
fused phase's to the bit."""
import importlib.util
import os

import numpy as np
import pytest
import torch

from dartenv_tpu_torch.engine import hopper_substep as hs
from dartenv_tpu_torch.envs.base import with_solver
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.validation import residual

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script():
    spec = importlib.util.spec_from_file_location(
        "torch_residual_envelope",
        os.path.join(ROOT, "scripts", "torch_residual_envelope.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_envelope_script_records_on_cpu():
    """The JAX script's keys and windows (warm-up min(warmup, T // 2)),
    each window's percentiles in order, the envelope at or below the
    residuals before the escalation, the overrides in the record."""
    before = hs.PLAIN_CALLS
    out = _script().main(["--device", "cpu", "--batch", "64", "--substeps",
                          "8", "--kmax", "3", "--iters2", "4", "--ref",
                          "1"])
    assert hs.PLAIN_CALLS - before == 8
    assert {"env", "batch", "substeps", "kmax", "frac", "ref64",
            "transient", "steady"} <= set(out)
    assert (out["batch"], out["substeps"], out["kmax"], out["ref"],
            out["escalation_k"]) == (64, 8, 3, 1, 2)
    assert out["finite_state"] and out["card"] == "cpu"
    for win in ("transient", "steady"):
        worst = list(out[win]["worst_over_substeps"].values())
        assert worst == sorted(worst) and np.isfinite(worst).all()
        pre = out["before_escalation"][win]["worst_over_substeps"]
        assert worst[-1] <= pre["p100"]
    # the escalation lowered the worst env of the batch somewhere
    assert (out["transient"]["worst_over_substeps"]["p100"]
            < out["before_escalation"]["transient"]["worst_over_substeps"][
                "p100"])


def test_envelope_substep_is_the_fused_phase():
    """make_envelope_substep steps as the fused phase does (bit for bit,
    float64 CPU, walker2d B = 16, 4 substeps), and its record is the
    substep's residuals with the escalated envs' lowered or kept."""
    model = make_task("walker2d", device="cpu", dtype=torch.float64).model
    sub = residual.make_envelope_substep(model)
    phase = hs.make_substep_phase(model)
    B, n = 16, model.n
    rng = np.random.default_rng(3)
    q = model.q_init[None] + torch.as_tensor(
        rng.uniform(-0.05, 0.05, (B, n)))
    q[:, 1] -= 0.03
    dq = torch.as_tensor(rng.uniform(-1.0, 1.0, (B, n)))
    tau = torch.as_tensor(rng.uniform(-80.0, 80.0, (B, n)))
    lam = torch.zeros((B, sub.st.layout.m), dtype=torch.float64)
    a, b = (q, dq, lam), (q, dq, lam)
    for _ in range(4):
        *a, diag = sub(*a, tau)
        qn, dqp, lamf, _ = phase(*b, tau)
        b = (qn, dqp, lamf)
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        env, pre = diag["envelope"], diag["res_pre"]
        assert (env <= pre).all()
        assert diag["idx"].shape == (1,)
        rest = torch.ones(B, dtype=torch.bool)
        rest[diag["idx"]] = False
        assert torch.equal(env[rest], pre[rest])


def test_envelope_substep_refuses_a_model_off_the_fused_phase():
    """walker2d in the "dantzig" mode steps phase-wise in the program, so
    the hook that reads the fused phase's escalation refuses it."""
    model = with_solver(make_task("walker2d", device="cpu").model,
                        "dantzig")
    assert hs.make_substep_phase(model) is None
    with pytest.raises(ValueError):
        residual.make_envelope_substep(model)
