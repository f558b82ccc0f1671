"""PyTorch port, the escalation kernel's plain versions add in the
kernel's order: every matvec and product entry from 0 over its index in
ascending order (math/linalg.seq_mv, seq_mm), a polish row as the
kernel's lane partials and butterfly (lcp/hopper_bpp.lane_sum).  On the
host (g++ builds of csrc/bpp_body.h and csrc/pgs_row.h, one lane, no a*b+c
contraction) the solve above 32 rows is then the plain version to the
bit, on the 3D models' escalated LCPs and on random ones."""
import shutil

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.math.linalg import seq_mm, seq_mv, seq_sum
from test_torch_kernels3d import _escalated_lcps, _random_lcps


def test_kernel_order_sums():
    """seq_mv / seq_mm / seq_sum add from 0 over the index in ascending
    order (one rounding per term), lane_sum in row_dot's tree; all four
    equal the exact sums in float64 on small integers."""
    rng = np.random.default_rng(0)
    a = torch.tensor(rng.integers(-9, 9, (3, 5, 37)), dtype=torch.float64)
    x = torch.tensor(rng.integers(-9, 9, (3, 37)), dtype=torch.float64)
    b = torch.tensor(rng.integers(-9, 9, (3, 37, 4)), dtype=torch.float64)
    torch.testing.assert_close(seq_mv(a, x), (a @ x[..., None])[..., 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(seq_mm(a, b), a @ b, rtol=0, atol=0)
    torch.testing.assert_close(seq_sum(x), x.sum(-1), rtol=0, atol=0)
    torch.testing.assert_close(hopper_bpp.lane_sum(a[:, 0] * x),
                               (a[:, 0] * x).sum(-1), rtol=0, atol=0)
    # float32: the order is the one of a sequential loop
    a32 = torch.tensor(rng.normal(size=(2, 3, 41)), dtype=torch.float32)
    x32 = torch.tensor(rng.normal(size=(2, 41)), dtype=torch.float32)
    acc = torch.zeros((2, 3))
    for j in range(41):
        acc = acc + a32[..., j] * x32[:, None, j]
    assert torch.equal(seq_mv(a32, x32), acc)


@pytest.mark.parametrize("case", ["walker3d_m36", "humanwalker_m41",
                                  "random_m64"])
def test_core_mode_above_32_rows_equals_plain_to_the_bit(case):
    """The core mode's host build (csrc/bpp_body.h) against
    bpp_solve_reference with the tier-1 budget of the model (walker3d
    8 + 2 pivots, humanwalker 16 + 6, 3 polish sweeps; random LCPs
    16 + 6): every impulse of every env equal to the bit."""
    if shutil.which("g++") is None:
        pytest.skip("no host C++ compiler")
    if case.startswith("random"):
        findex, g = _random_lcps(16, 64, 6)
        budgets = hopper_bpp.tier_budgets(16, 6, 0)
    else:
        name = case.split("_")[0]
        cfg, findex, g = _escalated_lcps(name, {"walker3d": 512,
                                                "humanwalker": 128}[name], 4)
        budgets = hopper_bpp.tier_budgets(cfg.escalate_iters,
                                          cfg.escalate_refine, 0)
    args = (g["A"], g["b"], g["lo"], g["hi"], findex, g["mu"], g["act"])
    kw = dict(iters=budgets[0], polish_iters=budgets[2], lam0=g["lam_c"],
              refine_iters=budgets[1])
    got = hopper_bpp.core_host(*args, **kw)
    ref = hopper_bpp.bpp_solve_reference(*args, **kw)
    assert got.shape == (16, int(case[-2:]))
    assert torch.equal(got, ref), int((got != ref).any(1).sum())
    assert float(ref.abs().max()) > 0
