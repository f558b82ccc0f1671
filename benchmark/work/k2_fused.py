"""Kernel 2's fused mode (csrc/bpp.cu bpp_fused_kernel): the escalation of
the worst K envs of a substep in one launch.  Bytes: each env's packed
escalation row and its dq_plus / lam_full rows read, the patched rows
written; operations: the operator rebuild from M and Jc, the tiers'
solves at the configuration's budgets, the refinement passes."""
from benchmark.work import k1_substep
from benchmark.work.peaks import escalate_flops, escalation_size

KERNEL = "bpp_fused_kernel"


def work(config, batch):
    s, sol = config["sizes"], config["solver"]
    n, m, m_c = s["n"], s["m"], s["m_c"]
    K = escalation_size(batch, sol["escalate_frac"], sol["escalate_kmax"])
    rows_in = k1_substep.esc_width(s) + n + m
    rows_out = n + m
    flops = escalate_flops(m_c, config["escalation_budgets"], rebuild_n=n)
    return 4 * (rows_in + rows_out) * K, flops * K
