"""What every driver shares: the cell's files found by name, the card's
checks, the result line and the checks printed beside it."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")
# top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "dartenv_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


class Cell:
    """One workload of BENCHMARK.json with its configuration, traffic,
    limits, configuration hooks and metrics, all found by name."""

    def __init__(self, name, bench=None):
        bench = bench or load_json(ROOT, "BENCHMARK.json")
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.workload = cells[name]
        self.name = name
        conf = {c["name"]: c for c in bench["configs"]}[
            self.workload["config"]]
        self.config = load_json(ROOT, conf["file"])
        self.traffic = load_json(BENCH, "traffic",
                                 self.workload["traffic"] + ".json")
        self.limits = load_json(BENCH, "limits", name + ".json")
        self.hooks = importlib.import_module(
            "benchmark.configs." + self.config["hooks"])
        e2e = [m for m in bench["end_to_end"]
               if name in m.get("workloads", [name])]
        self.end_to_end = {m["name"]: m for m in e2e}
        e2e_names = set(self.end_to_end)
        self.per_layer = {m["name"]: m for m in bench["per_layer"]
                          if name in m.get("workloads", [name])
                          and m["moves"] in e2e_names}
        self.chips = int(self.workload["chips"])

    @property
    def batch(self):
        return int(self.traffic["batch"])

    def ref_config(self):
        """The configuration as the reference runs it: with the traffic's
        pushes."""
        return dict(self.config, perturbation=self.traffic.get("pushes"))

    def skel_bytes(self):
        """The .skel file both sides read (the port's asset)."""
        path = os.path.join(ROOT, "dartenv_tpu_torch", "model", "assets",
                            self.config["asset"])
        with open(path, "rb") as f:
            return f.read()


class Context:
    """What the per-layer readers read: the cell, its configuration and
    batch, the traced slice's Profile, and the residual pass's records
    (res_pre, envelope) or None."""

    def __init__(self, cell, profile, residual=None):
        self.cell, self.config = cell, cell.config
        self.batch = cell.batch
        self.profile = profile
        self.residual = residual


def reader(metric):
    """The per-layer metric's reader: benchmark/metrics/<name>.py's
    `read(ctx)`, loaded by path."""
    path = os.path.join(BENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_per_layer(cell, ctx):
    """{name: {"value", "unit"}} of the cell's per-layer metrics; a reader
    that finds nothing to read returns None and its metric is left out."""
    out = {}
    for name, m in cell.per_layer.items():
        v = reader(name)(ctx)
        if v is not None:
            out[name] = {"value": v, "unit": m["unit"]}
    return out


def require_card(chips):
    """Exit with code 2 and no result when torch sees no CUDA card or
    fewer than `chips`."""
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this benchmark runs only on the card",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"{torch.cuda.device_count()} CUDA devices, the cell needs "
              f"{chips}", file=sys.stderr)
        raise SystemExit(2)


def steady_host():
    """The end of set-up: a full collection, then every object that set-up
    made (imports, the model, the env) moved out of the garbage
    collector's reach (gc.freeze), so that a collection inside the window
    walks the window's own objects and not the whole process.  The window
    still collects its own garbage; `release_host` undoes this once the
    window has closed."""
    gc.collect()
    gc.freeze()


def release_host():
    """After the window: set-up's objects back under the collector, so
    that freeing the program frees them."""
    gc.unfreeze()
    gc.collect()


def cache_dirs():
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(ROOT, "build")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ.setdefault(var, os.path.join(base, sub))


def forbidden_modules():
    """Loaded modules whose top-level name is one of FORBIDDEN."""
    return sorted({k.split(".")[0] for k in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit():
    """The card's power limit as nvidia-smi reads it, or "unknown"."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip().splitlines()[0] if r.returncode == 0 \
            else "unknown"
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def device_info(torch, count, peak):
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": count, "memory_peak_bytes": int(peak)}


def emit(correct, attempted, failed, metrics, device, checks,
         breakdown=None):
    """The checks on standard error, then the result as the last line of
    standard output; none when a forbidden module was loaded."""
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: " + ", ".join(bad), file=sys.stderr)
        raise SystemExit(3)
    line = {"correct": bool(correct), "attempted": int(attempted),
            "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
