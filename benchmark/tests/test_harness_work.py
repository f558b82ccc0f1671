"""The work functions, computed from the configuration files alone, give
the bounds the port's kernel table records (PERF.md, the table of
kernels: chip_smoke.py's arithmetic on the run's shapes)."""
import json
import os

import pytest

from benchmark.work import k1_substep, k2_fused, k2_hybrid, k4_pgs
from benchmark.work.peaks import escalation_size, least_ms

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def config(name):
    with open(os.path.join(HERE, "configs", name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("kernel,cfg,batch,mb,ms,by", [
    (k1_substep, "walker2d", 4096, 10.67, 0.00318, "bytes"),
    (k2_fused, "walker2d", 4096, None, 0.000224, "operations"),
    (k2_hybrid, "walker2d", 4096, None, 0.000196, "operations"),
    (k4_pgs, "walker2d", 4096, 12.2, 0.00364, "bytes"),
    (k1_substep, "humanwalker", 1024, None, 0.00444, "operations"),
    (k2_fused, "humanwalker", 1024, None, 0.00349, "operations"),
])
def test_work_matches_the_recorded_bound(kernel, cfg, batch, mb, ms, by):
    b, f = kernel.work(config(cfg), batch)
    got, bound_by = least_ms(b, f)
    assert bound_by == by
    assert got == pytest.approx(ms, rel=5e-3)
    if mb is not None:
        assert b / 1e6 == pytest.approx(mb, rel=5e-3)


def test_escalation_size_and_scaling():
    c = config("walker2d")
    assert escalation_size(8192, 1 / 32, 128) == 128
    assert escalation_size(1024, 1 / 8, 128) == 128
    assert escalation_size(100, 1 / 32, 128) == 4
    b1, f1 = k1_substep.work(c, 4096)
    b2, f2 = k1_substep.work(c, 8192)
    assert (b2, f2) == (2 * b1, 2 * f1)
