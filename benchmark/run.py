"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload walker2d-b8192 --seed 7 \
        --seconds 30 --trace 0

Prints the checks on standard error and, as the last line of standard
output, one JSON object: correct, attempted, failed, metrics (the cell's
end-to-end metrics with --trace 0, its per-layer metrics with --trace 1),
device, with --trace 1 breakdown, and last the checks.  Exits 2 without a
result where torch sees no CUDA card (or fewer than the cell needs), and
3 where a module of JAX or of the JAX package was loaded.

`--control` puts the reference, held in bfloat16, in the program's place
(the check must then fail); the benchmark's own runs never pass it.
"""
import os
import time


def _process_age():
    """Seconds since this process started (/proc, 10 ms ticks)."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


# setup_s counts from the process's start
T0 = time.perf_counter() - _process_age()

import argparse  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)

    from benchmark.harness import common

    common.cache_dirs()
    cell = common.Cell(args.workload)
    import torch

    # one process with one host thread for torch's CPU work
    torch.set_num_threads(1)
    common.require_card(cell.chips)
    driver = __import__("benchmark.harness." + cell.traffic["driver"],
                        fromlist=["run"])
    out = driver.run(cell, args, T0, device="cuda", control=args.control)
    print(f"card {torch.cuda.get_device_name(0)}, power limit "
          f"{common.power_limit()}; rooflines against 3.35 TB/s and "
          f"67 TFLOP/s (H100 SXM data sheet, float32, 700 W)",
          file=sys.stderr)
    common.emit(out["correct"], out["attempted"], out["failed"],
                out["metrics"], out["device"], out["checks"],
                out.get("breakdown"))


if __name__ == "__main__":
    main()
