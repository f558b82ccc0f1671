"""PyTorch port, the JAX residual harness's own protocol through the port
(tests/test_pgs_residuals.py), as validation/residual.py runs it: one env
(B = 1), 160 substeps under the seeded torques, the normalized
complementarity residual of each LCP that engine/world.make_lcp_capture
captures, gated at the JAX bounds.  Here the hopper on the plain float32
path on the CPU (the port's walker2d takes about 17 s on this protocol and
is gated on the card by chip_smoke.py's phase harness_envelope)."""
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.engine.world import init_state, make_lcp_capture
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.validation import residual
from test_pgs_residuals import comp_residual


def test_hopper_meets_the_jax_envelope():
    """JAX bounds for the hopper: median < 1e-6, p95 < 1e-5, max < 1e-4."""
    r, _ = residual.harness_residuals("hopper", device="cpu")
    assert residual.JAX_ENVELOPE["hopper"] == (1e-6, 1e-5, 1e-4)
    assert len(r) > 20, "rollout never made contact — test is vacuous"
    assert np.median(r) < 1e-6, f"median residual {np.median(r):.2e}"
    assert np.percentile(r, 95) < 1e-5, \
        f"p95 residual {np.percentile(r, 95):.2e}"
    assert r.max() < 1e-4, f"max residual {r.max():.2e}"


@pytest.mark.parametrize("perturb", [0.0, 1e-3])
def test_residual_equals_the_jax_harness(perturb):
    """The port's comp_residual equals the JAX harness's to 1e-15 (the
    same float64 numpy operations) on the LCPs that make_lcp_capture
    captures from 16 seeded hopper states pushed into the ground, with the
    engine's impulses, and with them moved off the solution by a seeded
    relative `perturb` (so the residual is not near 0)."""
    task = make_task("hopper", dtype=torch.float32, device="cpu")
    model = task.model
    rng = np.random.default_rng(7)
    B = 16
    state = init_state(model, B)
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
    state.q[:] += f32(rng.normal(0.0, 0.05, (B, model.n)))
    state.q[:, 1] -= f32(rng.uniform(0.0, 0.1, B))
    state.dq[:] = f32(rng.normal(0.0, 0.5, (B, model.n)))
    tau = f32(rng.uniform(-1.0, 1.0, (B, model.n))) * 200.0
    tau[:, :3] = 0.0
    p = make_lcp_capture(model)(state, tau)
    h = {k: v.double().numpy() for k, v in p.items() if torch.is_tensor(v)}
    seen = 0
    for e in range(B):
        lam = h["lam"][e]
        if np.abs(lam).max() <= 1e-9:
            continue
        seen += 1
        act = h["active"][e] > 0.5
        x = lam * (1.0 + perturb * rng.standard_normal(lam.shape))
        lp = dict(A=h["A"][e], b=h["b"][e], x=x,
                  lo=np.where(act, h["lo"][e], 0.0),
                  hi=np.where(act, h["hi"][e], 0.0),
                  findex=np.asarray(p["findex"]), mu=h["mu"][e],
                  active=act.astype(np.float64))
        want = comp_residual(**lp)
        assert abs(residual.comp_residual(**lp) - want) <= 1e-15 * max(
            1.0, want)
    assert seen >= 8, seen
