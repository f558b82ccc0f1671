"""Kernel 2's hybrid mode (csrc/bpp.cu bpp_hybrid_kernel): the phase-wise
solver's escalation of the worst K envs in one launch.  Bytes: each env's
A (m x m), its six vectors and lam read, lam written; operations: the
tiers' solves at the configuration's budgets and the refinement passes
(no rebuild: A is given)."""
from benchmark.work.peaks import escalate_flops, escalation_size

KERNEL = "bpp_hybrid_kernel"


def work(config, batch):
    m, sol = config["sizes"]["m_c"], config["solver"]
    K = escalation_size(batch, sol["escalate_frac"], sol["escalate_kmax"])
    flops = escalate_flops(m, config["escalation_budgets"])
    return 4 * (m * m + 7 * m + m) * K, flops * K
