"""The traced slice's reduction on a hand-made Chrome trace: launches
attributed to the host range they were launched from, the union of
device intervals, kernel times, the breakdown; and a profile that caught
no device event is refused, never read as 0."""
import pytest

from benchmark.harness.trace import NoDeviceEvents, Profile

TID = 7


def ev(name, cat, ts, dur, **args):
    return {"name": name, "cat": cat, "ts": ts, "dur": dur, "tid": TID,
            "args": args}


def launch(corr, ts, kernel, k_ts, k_dur, cat="kernel"):
    return [ev("cudaLaunchKernel", "cuda_runtime", ts, 2, correlation=corr),
            dict(ev(kernel, cat, k_ts, k_dur, correlation=corr), tid=0)]


def events():
    out = [ev("bench_slice", "user_annotation", 0, 1000),
           ev("substep_fused", "user_annotation", 100, 200),
           ev("bench_inputs", "user_annotation", 10, 20),
           ev("aten::add", "cpu_op", 500, 50)]
    out += launch(1, 110, "substep_kernel(float*)", 150, 100)
    out += launch(2, 250, "bpp_fused_kernel(float*)", 260, 40)
    out += launch(3, 12, "fill", 30, 10)
    out += launch(4, 510, "add", 520, 30)
    out += launch(5, 520, "memcpy", 600, 100, cat="gpu_memcpy")
    out += launch(6, 2000, "late", 2000, 10)     # after the slice
    return out


def test_reduction():
    p = Profile(events(), steps=2)
    assert p.window_s == pytest.approx(1e-3)
    # 5 operations launched inside the slice, 2 steps
    assert p.launches() == 2.5
    assert p.launches(ranges=("substep_fused",)) == 1.0
    assert p.launches(exclude=("substep_fused", "bench_inputs")) == 1.0
    # busy: [30,40] [150,250] [260,300] [520,550] [600,700]
    assert p.busy_s == pytest.approx((10 + 100 + 40 + 30 + 100) * 1e-6)
    assert p.kernel_ms("substep_kernel") == (1, pytest.approx(0.1))
    assert p.kernel_ms("pgs_kernel") is None
    b = p.breakdown()
    assert b["device_ops"][0][0] in ("substep_kernel(float*)", "memcpy")
    assert len(b["device_ops"]) == 5
    gaps = dict(b["idle_gaps"])
    assert gaps["aten::add"] == pytest.approx(50e-6)        # 550..600
    assert gaps["substep_fused"] == pytest.approx(220e-6)   # 300..520
    assert gaps["host (no op)"] == pytest.approx(440e-6)
    assert sum(gaps.values()) == pytest.approx(
        1e-3 - p.busy_s)


def test_no_device_event_is_refused():
    ev_ = [e for e in events() if e["cat"] not in ("kernel", "gpu_memcpy")]
    with pytest.raises(NoDeviceEvents):
        Profile(ev_, steps=2)
