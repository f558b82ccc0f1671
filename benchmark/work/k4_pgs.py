"""Kernel 4 (csrc/pgs.cu pgs_kernel): warm-started PGS sweeps over B envs'
boxed LCPs of m_c rows, with the normalized residual.  Bytes: A, the six
vectors in, lam and the residual out; operations: the sweeps and the
residual's matvec."""

KERNEL = "pgs_kernel"


def work(config, batch):
    m, iters = config["sizes"]["m_c"], config["solver"]["pgs_iters"]
    words = m * m + 7 * m + 1
    flops = 2 * (iters + 1) * m * (m + 4)
    return 4 * words * batch, flops * batch
