"""Kernel 1 (csrc/substep.cu): one fused substep of B envs.  Bytes: q, dq,
tau and lam_prev read once, the eight outputs (dq_plus, lam_full, res,
overflow, contact positions, depths and flags, the packed escalation row)
written once; operations: dense counts of the stages that dominate."""

KERNEL = "substep_kernel"


def esc_width(s):
    """Floats of one env's packed escalation row: b, lo, hi, mu, act,
    lam_c (m_c each), the selected slots (cap), M (n x n), Jc (m_c x n)."""
    n, m_c = s["n"], s["m_c"]
    return 6 * m_c + s["cap"] + n * n + m_c * n


def work(config, batch):
    """(bytes, flops) of one launch over `batch` envs."""
    s = config["sizes"]
    n, nb, m, m_c = s["n"], s["nb"], s["m"], s["m_c"]
    ns, cap = s["contact_slots"], s["cap"]
    iters = config["solver"]["pgs_iters"]
    outs = n + m + 1 + 1 + 3 * ns + ns + ns + esc_width(s)
    words = 3 * n + m + outs
    flops = (
        2 * (iters + 1) * m_c * m_c             # PGS sweeps + residual
        + n * m_c * (m_c + 1)                   # A = Jc (M^-1 Jc^T), half
        + m_c * 2 * n * n                       # M^-1 Jc^T substitutions
        + 2 * (n ** 3 // 3 + 2 * n * n)         # two Cholesky solves
        + nb * (n * 60 + n * (n + 1) * 6)       # mass matrix
        + nb * 400                              # kinematics + bias forces
        + ns * 60 + cap * n * 40                # collision + contact rows
        + 2 * n * m_c                           # dq_plus
    )
    return 4 * words * batch, flops * batch
