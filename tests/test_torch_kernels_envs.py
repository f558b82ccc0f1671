"""PyTorch port, kernel 1's arithmetic (csrc/substep_body.h) on the last
three env ids' digests, built with the host C++ compiler (g++) and run as
one lane per env, against the plain PyTorch version, float32, 32 seeded
states each:
  * dog (n 18, 20 contact slots compacted to 8, m_c 36): discrete and
    copied blocks equal to the plain version's; computed blocks within
    1e-4 of the plain version evaluated in float64 on the same inputs and
    within 2e-2 of the float32 one (above 12 dofs the float32 plain
    version inverts M with a relative 1e-6 jitter the kernel does not
    add, as tests/test_torch_kernels3d.py holds walker3d);
  * snake7link (n 9, 14 slots, contact_cap 0: the uncompacted contact
    branch, SS_COMPACT = 0, m_c = m = 48), on the shipped model (its
    capsules sit at zero depth: limit rows only, pushed past their
    limits) and on the model with the ground raised by 1 cm (every slot
    active): computed blocks within 2e-4 of the float64 plain version, the
    JAX package's bound for what passes through the n x n solve
    (tests/test_pallas_dynamics.py, dq_star): the snake's mass matrix has
    condition numbers near 1e4 here, and its float32 plain version is as
    far from float64 as the kernel (1.1e-4 on b and 1.3e-4 on dq_plus);
  * reacher2d (n 2, one limit row, no slots): within 1e-4 of the float32
    plain version."""
import shutil

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.engine import hopper_substep as ths
from dartenv_tpu_torch.envs.tasks import make_task
from torch_port_util import rel_err

DISCRETE = ("con_active", "act", "sel_slots", "overflow", "lo", "hi", "mu")


def _case(case, B=32, seed=1):
    """(model, digest, float32 inputs) of one case: the initial pose moved
    a little, the dog's torso lowered into the ground, limited dofs pushed
    past their upper limit in every second env where contacts are not
    live (as chip_smoke.py does), random torques and warm starts."""
    name = case.split("_")[0]
    task = make_task(name, device="cpu")
    model = task.model
    if case.endswith("sunk"):
        model = model.replace(wg_offset=model.wg_offset + 0.01)
    st = ths._SubStatic(model)
    rng = np.random.default_rng(seed)
    q = model.q_init.numpy()[None] + rng.uniform(-0.05, 0.05, (B, model.n))
    if name == "dog":
        q[:, 4] -= rng.uniform(0.0, 0.1, B)
    elif not case.endswith("sunk"):
        lim = model.host("limited") > 0
        up = model.host("q_upper")
        q[::2, lim] = up[lim] + rng.uniform(0.0, 0.1, (B // 2,
                                                       int(lim.sum())))
    dq = rng.uniform(-1.0, 1.0, (B, model.n))
    a = rng.uniform(-1.0, 1.0, (B, task.action_size))
    tau = task.action_to_tau(torch.as_tensor(a, dtype=torch.float32),
                             ()).numpy()
    lam = rng.uniform(0.0, 0.5, (B, st.layout.m))
    f = lambda x: torch.as_tensor(x, dtype=torch.float32)
    return model, st, (f(q), f(dq), f(tau), f(lam))


@pytest.mark.parametrize("case", ["dog", "snake7link", "snake7link_sunk",
                                  "reacher2d"])
def test_substep_host_build_matches_plain(case):
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    model, st, ins = _case(case)
    got = ths.SubstepKernel(model, st).run_host(*ins)
    ref = ths.substep_reference(model, st, *ins)
    m64 = model.to(dtype=torch.float64)
    ref64 = ths.substep_reference(m64, ths._SubStatic(m64),
                                  *[x.double() for x in ins])
    g, r, r64 = (ths.output_blocks(st, o) for o in (got, ref, ref64))
    for f in DISCRETE:
        if f in g:
            assert torch.equal(g[f], r[f]), f
    assert st.compact == (case == "dog")
    live = float(r["act"].sum())
    assert live >= 16, "constraint rows are not live"
    if case in ("dog", "snake7link_sunk"):
        assert float(r["con_active"].sum()) > 32, "contacts are not live"
    if case == "snake7link":
        assert float(r["con_active"].sum()) == 0
    computed = [f for f in g if f not in DISCRETE and g[f].numel()]
    errs = {f: (rel_err(g[f], r[f]), rel_err(g[f], r64[f]))
            for f in computed}
    for f, (e32, e64) in errs.items():
        if case == "dog":
            assert e64 <= 1e-4 and e32 <= 2e-2, (f, e32, e64)
        elif case.startswith("snake"):
            assert e64 <= 2e-4, (f, e64)
        else:
            assert e32 <= 1e-4, (f, e32)
