"""Where a traced slice's time goes, span by span.

    python3 scripts/span_breakdown.py --workload walker2d-b8192 --seed 7 \
        --seconds 51 --out out/spans.json

Runs one cell of the benchmark once with --trace 1 (benchmark/run.py,
which prints its result line as usual) from the checkout in the current
directory, so the same script reads a parent commit's checkout, and
writes the traced slice split by span to --out: device operations per
control step by innermost span; host ms per control step in each span and
its self time (less the spans inside it); the runtime calls that block
the host and the copies of pageable memory, by innermost span; the idle
gaps by host activity; the slice's ms per control step.  Runs only on
the card, as benchmark/run.py does.
"""
import argparse
import collections
import json
import os
import sys

sys.path.insert(0, os.getcwd())

BLOCKING = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
            "cudaEventSynchronize", "cudaMemcpy")


def split(p):
    """The slice's Profile `p` (benchmark/harness/trace.py), split by
    span, per control step."""
    per = lambda n: n / p.steps
    launches = collections.Counter(str(r) for *_, r in p.ops)
    spans = sorted((a, b, n) for n, v in p.ranges.items() for a, b in v)
    host, own = collections.Counter(), collections.Counter()
    for a, b, n in spans:
        host[n] += b - a
        inner, end = 0.0, a
        for x, y, _ in spans:
            if (x, y) == (a, b) or x < a or y > b:
                continue
            x = max(x, end)
            if y > x:
                inner += y - x
                end = y
        own[n] += b - a - inner
    calls = collections.defaultdict(lambda: [0, 0.0])
    for a, b, name in p.host_events:
        if name in BLOCKING:
            c = calls[f"{name} in {p.range_at(a, p.tid)}"]
            c[0] += 1
            c[1] += b - a
    pageable = collections.Counter(
        f"{name} in {r}" for name, cat, *_, r in p.ops
        if cat == "gpu_memcpy" and "Pageable" in name)
    return {
        "steps": p.steps,
        "slice_ms_per_step": per(p.window_s * 1e3),
        "busy_ms_per_step": per(p.busy_s * 1e3),
        "launches_per_step": {k: per(v) for k, v in launches.most_common()},
        "host_ms_per_step": {k: per(v * 1e-3) for k, v in host.most_common()},
        "self_ms_per_step": {k: per(v * 1e-3) for k, v in own.most_common()},
        "blocking_calls_per_step": {k: [per(n), per(us * 1e-3)]
                                    for k, (n, us) in calls.items()},
        "pageable_copies_per_step": {k: per(v) for k, v in pageable.items()},
        "breakdown": p.breakdown(top=1000),
        "idle_ms_per_step": per(p.window_s * 1e3 - p.busy_s * 1e3),
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=51)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()

    from benchmark import run
    from benchmark.harness import batched, gym, trace

    def read_slice(box):
        p = trace.read_slice(box)
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(split(p), f, indent=1)
        return p

    batched.read_slice = gym.read_slice = read_slice
    run.main(["--workload", args.workload, "--seed", str(args.seed),
              "--seconds", str(args.seconds), "--trace", "1"])


if __name__ == "__main__":
    main()
