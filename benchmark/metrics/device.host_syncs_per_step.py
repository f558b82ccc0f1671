"""Runtime calls per control step that block the host on the card, with a
program span innermost (not one of the benchmark's own ranges): stream,
device and event synchronizations, cudaMemcpy, and every call that
copied pageable host memory (its `Memcpy ... (Pageable ...)` on the
card).  A cudaMemcpy of pageable memory counts once."""
from benchmark.harness.trace import BENCH_RANGES

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def read(ctx):
    p = ctx.profile
    if p is None or not set(p.ranges) - set(BENCH_RANGES):
        return None
    program = lambda r: r is not None and r not in BENCH_RANGES
    calls = [(a, b, name) for a, b, name in p.host_events
             if name in BLOCKING and program(p.range_at(a, p.tid))]
    memcpy = [(a, b) for a, b, name in calls if name == "cudaMemcpy"]
    pageable = [
        1 for name, cat, a, _, r in p.ops
        if cat == "gpu_memcpy" and "Pageable" in name and program(r)
        and not any(x <= a <= y for x, y in memcpy)]
    return (len(calls) + len(pageable)) / p.steps
