"""Scan of the block-pivoting solvers' float32 sensitivity (not a test).

    JAX_PLATFORMS=cpu python scripts/torch_bpp_seed_scan.py [first] [last]

For each seed of the `_problems` generator it warm-starts (10 PGS sweeps)
the JAX Pallas BPP kernel in interpret mode and the port's plain version
(float32, 8 + 6 pivots, 3 polish sweeps) and prints both worst residuals
and the largest impulse difference, and the port's worst residual on the
same problems in float64 (same budget).  The spread comes from the re-open test of the
pivot body: a free row's w = (A x + b)_i is rounding noise of the masked
solve (~1e-7 in float32) compared with 1e-10, so its sign decides whether
a row clamped in one pivot re-opens in the next.
"""
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, _ROOT)
sys.path.insert(0, os.path.join(_ROOT, "tests"))    # the tests' generators

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dartenv_tpu.lcp.pallas_bpp import bpp_solve_pallas  # noqa: E402
from dartenv_tpu.lcp.pgs import pgs_solve  # noqa: E402
from dartenv_tpu_torch.lcp.hopper_bpp import bpp_solve_reference  # noqa: E402
from test_torch_bpp import _jax_resid, _problems  # noqa: E402
from torch_port_util import N, T  # noqa: E402


def main(first=2, last=11):
    for seed in range(first, last + 1):
        p = _problems(seed=seed)
        A, b, lo, hi, mu, act, findex = p
        j = lambda x: jnp.asarray(x, jnp.float32)
        lam0 = np.asarray(jax.vmap(
            lambda *a: pgs_solve(a[0], a[1], a[2], a[3], findex, a[4], a[5],
                                 iters=10))(j(A), j(b), j(lo), j(hi), j(mu),
                                            j(act)))
        lp = np.asarray(bpp_solve_pallas(
            j(A), j(b), j(lo), j(hi), findex, j(mu), j(act), interpret=True,
            lam0=j(lam0), iters=8, polish_iters=3))

        def port(dtype):
            t = lambda x: T(x, dtype)
            return N(bpp_solve_reference(
                t(A), t(b), t(lo), t(hi), findex, t(mu), t(act),
                lam0=t(lam0), iters=8, polish_iters=3))

        lr = port(torch.float32)
        resid = lambda lam: _jax_resid(p, lam, jnp.float64).max()
        print(f"seed {seed}: pallas-interpret f32 {resid(lp):.3e}  "
              f"port-plain f32 {resid(lr):.3e}  max|dlam| "
              f"{np.abs(lp - lr).max():.3e}  port-plain f64 "
              f"{resid(port(torch.float64)):.3e}")


if __name__ == "__main__":
    main(*[int(a) for a in sys.argv[1:3]])
