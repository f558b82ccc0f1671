"""The reference against the program's own plain path on the CPU (its
float32 plain versions, which the kernels are held to): the same inputs
give the same control step, to the bit, on the fused path, the pushed
phase-wise path and the humanoid; and the reference in float64 stays
within float32 rounding of it."""
import pytest
import torch

from benchmark.harness import common
from benchmark.reference.env import RefEnv

CASES = [("walker2d-b8192", 8, 2), ("walker2d-push-b8192", 8, 2),
         ("humanwalker-b1024", 2, 1)]


@pytest.mark.parametrize("workload,B,steps", CASES)
def test_reference_equals_the_plain_path(workload, B, steps):
    import dartenv_tpu_torch as port
    from dartenv_tpu_torch.parallel.vec_env import VecEnv

    cell = common.Cell(workload)
    task = port.make(cell.config["env_id"], device="cpu").unwrapped.task
    push = cell.traffic["pushes"]
    if push is not None:
        task.add_perturbation = True
        task.perturbation_parameters = tuple(push)
    g = torch.Generator().manual_seed(5)
    venv = VecEnv(task, B, max_episode_steps=cell.traffic[
        "max_episode_steps"], generator=g)
    st, _ = venv.reset()
    ref32 = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                   device="cpu", dtype=torch.float32)
    ref64 = RefEnv(cell.ref_config(), cell.skel_bytes(), cell.hooks,
                   device="cpu", dtype=torch.float64)
    for _ in range(steps):
        a = torch.rand((B, task.action_size), generator=g) * 2 - 1
        rn = task.reset_noise_sample(B, g)
        pn = task.perturb_noise_sample(B, g) if push else None
        pre = dict(q=st.sim.q, dq=st.sim.dq, lam=st.sim.lam, steps=st.steps)
        if push:
            pre.update(st.aux)
        st, obs, r, d, info = venv.step(st, a, reset_noise=rn,
                                        perturb_noise=pn)
        out = ref32.step(pre, a, rn, pn, cell.traffic["max_episode_steps"])
        for k, v in (("q", st.sim.q), ("dq", st.sim.dq),
                     ("lam", st.sim.lam), ("obs", obs), ("reward", r),
                     ("terminal_obs", info["terminal_obs"])):
            assert torch.equal(out[k], v), k
        assert torch.equal(out["done"], d)
        o64 = ref64.step(pre, a, rn, pn, cell.traffic["max_episode_steps"])
        gap = ((o64["terminal_obs"] - out["terminal_obs"].double()).abs()
               / (1 + o64["terminal_obs"].abs()))
        assert float(gap.max()) < 1e-2
        assert float(gap.median()) < 1e-4
