"""PyTorch port, package hygiene: the port and chip_smoke.py import
neither jax nor the JAX package; full-f32 products are pinned at import;
CUDA-only calls raise on a machine without a GPU instead of running on
the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

import dartenv_tpu_torch
import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu_torch.bench.throughput import bench_env
from dartenv_tpu_torch.envs.tasks import make_task

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "dartenv_tpu_torch")


def _port_sources():
    # the port, chip_smoke.py and the child-process script of the port's
    # multi-process tests (it runs the port alone)
    files = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "tests", "torch_dist_child.py")]
    for d, _dirs, names in os.walk(PKG):
        files += [os.path.join(d, f) for f in names if f.endswith(".py")]
    return sorted(files)


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


def test_port_sources_exist():
    files = _port_sources()
    assert len(files) > 25
    for sub in ("model", "math", "dynamics", "collision", "lcp", "engine",
                "envs", "parallel", "bench"):
        assert os.path.exists(os.path.join(PKG, sub, "__init__.py")), sub
    for f in ("csrc/substep.cu", "csrc/bpp.cu", "csrc/dynamics.cu",
              "csrc/pgs.cu", "csrc/dynamics_body.h",
              "csrc/dynamics_host.cpp", "csrc/pgs_row.h",
              "csrc/escalate_body.h", "csrc/escalate_host.cpp",
              "csrc/pgs_host.cpp", "csrc/integrate.cu",
              "csrc/integrate_body.h", "csrc/integrate_host.cpp",
              "dynamics/hopper_integrate.py",
              "model/assets/walker2d.skel",
              "model/assets/hopper_capsule.skel",
              "model/assets/cartpole.skel",
              "model/assets/doublependulum.skel",
              "dynamics/hopper_dynamics.py", "lcp/hopper_pgs.py",
              "envs/cart_pole.py", "envs/double_pendulum.py",
              "parallel/domain_rand.py", "parallel/train.py",
              "parallel/sharding.py", "model/urdf_loader.py",
              "model/sdf_loader.py", "native/__init__.py",
              "model/assets/gen_humanwalker.py"):
        assert os.path.exists(os.path.join(PKG, f)), f


def test_no_jax_import():
    """AST walk over every module of the port and chip_smoke.py."""
    banned = {"jax", "jaxlib", "dartenv_tpu", "flax", "optax"}
    bad = {os.path.relpath(p, ROOT): sorted(_imported_roots(p) & banned)
           for p in _port_sources() if _imported_roots(p) & banned}
    assert not bad, bad


def _imported_modules(path):
    """Every module name that `path` imports, relative imports resolved
    and `from pkg import name` counted as pkg.name."""
    pkg = os.path.relpath(os.path.dirname(path), ROOT).split(os.sep)
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(pkg[:len(pkg) - node.level + 1] if node.level
                            else [])
            mod = ".".join(p for p in (base, node.module or "") if p)
            mods.add(mod)
            mods |= {f"{mod}.{a.name}" for a in node.names}
    return mods


def test_no_library_module_imports_the_bench():
    """The measurement tools of bench/ sit above the library: no module
    of the port outside bench/ imports them."""
    bench = os.path.join(PKG, "bench") + os.sep
    bad = {}
    for p in _port_sources():
        if not p.startswith(PKG + os.sep) or p.startswith(bench):
            continue
        hits = sorted(m for m in _imported_modules(p)
                      if m == "dartenv_tpu_torch.bench"
                      or m.startswith("dartenv_tpu_torch.bench."))
        if hits:
            bad[os.path.relpath(p, ROOT)] = hits
    assert not bad, bad


def test_port_imports_without_jax_in_a_fresh_process():
    code = ("import sys, importlib, pkgutil, dartenv_tpu_torch as p\n"
            "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'dartenv_tpu')]\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT,
                   timeout=120)


def test_tf32_is_off_after_import():
    assert dartenv_tpu_torch is not None
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_cuda_only_calls_raise_without_a_gpu():
    """The default device is "cuda": with no GPU the entry points raise;
    none of them quietly runs on the CPU."""
    if torch.cuda.is_available():
        return                     # a GPU machine has nothing to refuse
    with pytest.raises((RuntimeError, AssertionError)):
        make_task("walker2d")
    with pytest.raises((RuntimeError, AssertionError)):
        bench_env("walker2d", batch=2, horizon=1, iters=1)
    out = subprocess.run([sys.executable, os.path.join(ROOT,
                                                       "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
