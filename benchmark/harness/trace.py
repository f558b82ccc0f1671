"""The traced slice: a torch.profiler profile of a few control steps inside
the window, reduced to what the per-layer readers take.

`traced_slice` starts the profiler (host ops and the card's activity) and
marks the slice with the host range `bench_slice` between two
synchronizations; `read_slice`, once the window has closed, reads the
profile's Chrome trace once from a temporary file, which it deletes.  `Profile` holds the reduction: device operations (kernels,
copies, sets) in the slice, each with the host range it was launched
from, the union of their intervals, and the slice's wall span.
"""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile

# the engine's record_function ranges (engine/world.py)
ENGINE_RANGES = ("substep_fused", "dynamics", "collision", "constraints",
                 "integrate", "substep_fused_dr")
# the benchmark's own ranges: its inputs and its failure count
BENCH_RANGES = ("bench_inputs", "bench_count")
SLICE = "bench_slice"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class NoDeviceEvents(RuntimeError):
    """The profile caught no device operation in the slice."""


class Profile:
    """A traced slice, reduced.  `steps`: the control steps (or env.step
    calls) inside it."""

    def __init__(self, events, steps):
        self.steps = steps
        host = [e for e in events if e.get("name") == SLICE
                and e.get("cat") == "user_annotation"]
        if not host:
            raise NoDeviceEvents("the profile holds no bench_slice range")
        sl = host[0]
        self.tid = sl["tid"]
        self.t0, self.t1 = sl["ts"], sl["ts"] + sl.get("dur", 0)
        self.window_s = (self.t1 - self.t0) * 1e-6
        # host ranges on the slice's thread, by name
        self.ranges = {}
        for e in events:
            if (e.get("cat") == "user_annotation" and e.get("tid") == self.tid
                    and e.get("name") != SLICE):
                self.ranges.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e.get("dur", 0)))
        for v in self.ranges.values():
            v.sort()
        launch = {}
        for e in events:
            corr = e.get("args", {}).get("correlation")
            if e.get("cat") == "cuda_runtime" and corr is not None:
                launch[corr] = e
        self.ops = []       # (name, cat, start, end, host range or None)
        for e in events:
            if e.get("cat") not in DEVICE_CATS:
                continue
            start, end = e["ts"], e["ts"] + e.get("dur", 0)
            rt = launch.get(e.get("args", {}).get("correlation"))
            at = rt["ts"] if rt is not None else None
            if at is None or not (self.t0 <= at <= self.t1):
                continue
            self.ops.append((e.get("name", "?"), e["cat"], start, end,
                             self.range_at(at, rt.get("tid"))))
        if not self.ops:
            raise NoDeviceEvents(
                "the profile caught no device operation launched in the "
                "slice")
        self.host_events = sorted(
            ((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", "?"))
             for e in events if e.get("tid") == self.tid
             and e.get("cat") in ("cpu_op", "user_annotation", "cuda_runtime")
             and e.get("name") != SLICE), key=lambda x: x[0])
        self.host_starts = [a for a, _, _ in self.host_events]
        self.busy = self._union([(a, b) for _, _, a, b, _ in self.ops])

    def range_at(self, ts, tid):
        """The innermost named host range (of ENGINE_RANGES and
        BENCH_RANGES) holding ts on the slice's thread, or None."""
        if tid != self.tid:
            return None
        best = None
        for name, spans in self.ranges.items():
            for a, b in spans:
                if a <= ts <= b and (best is None or b - a < best[1]):
                    best = (name, b - a)
        return best[0] if best else None

    def _union(self, spans):
        """Merged intervals of spans, clipped to the slice."""
        out = []
        for a, b in sorted(spans):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self):
        return sum(b - a for a, b in self.busy) * 1e-6

    def launches(self, ranges=None, exclude=()):
        """Device operations per step launched inside any of `ranges`
        (None: anywhere) and outside `exclude`."""
        n = sum(1 for *_, r in self.ops
                if (ranges is None or r in ranges) and r not in exclude)
        return n / self.steps

    def kernel_ms(self, pattern):
        """(launches, mean device ms per launch) of the kernels whose name
        holds `pattern`, or None when there is none."""
        d = [b - a for name, cat, a, b, _ in self.ops
             if cat == "kernel" and pattern in name]
        if not d:
            return None
        return len(d), sum(d) / len(d) * 1e-3

    def breakdown(self, top=10):
        """The device operations that took most time, summed by name, and
        the longest idle gaps summed by what the host was doing."""
        by = {}
        for name, _, a, b, _ in self.ops:
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        ops = sorted(by.items(), key=lambda x: -x[1])[:top]
        gaps = {}
        edges = [self.t0] + [x for ab in self.busy for x in ab] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                what = self.host_at(a)
                gaps[what] = gaps.get(what, 0.0) + (b - a) * 1e-6
        idle = sorted(gaps.items(), key=lambda x: -x[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}

    def host_at(self, ts):
        """The innermost host event on the slice's thread holding ts: of
        the events begun by ts, the latest begun that has not ended."""
        k = bisect.bisect_right(self.host_starts, ts)
        for i in range(k - 1, max(-1, k - 5000), -1):
            a, b, name = self.host_events[i]
            if b >= ts:
                return name
        return "host (no op)"


@contextlib.contextmanager
def traced_slice(sync, steps):
    """with traced_slice(torch.cuda.synchronize, n) as box: run n steps;
    afterwards `read_slice(box)` is the reduced Profile (read once the window
    has closed)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    box = {}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    try:
        sync()
        with record_function(SLICE):
            yield box
            sync()
    finally:
        prof.stop()
    box.update(prof=prof, steps=steps)


def read_slice(box):
    """The Profile of a traced slice: its Chrome trace read once from a
    temporary file, which is deleted."""
    prof = box.pop("prof")
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return Profile(events, box["steps"])
