"""The C++ golden engines, loaded with ctypes: independent host
implementations of Featherstone's ABA (`native/aba.cpp`) and of a
boxed-LCP Dantzig pivoting solver with the friction-bound fixed point
(`native/lcp_dantzig.cpp`), at the repository root.  They hold the port's
per-body dynamics, its exact solvers and, on the card, kernels 3 and 2 to
a reference that shares no code with either package.

The sources are compiled with g++ on first use into a library of this
package under build/ (keyed by a hash of the sources, written under a
temporary name and renamed into place, so concurrent test workers never
load a half-written file).  `available()` is False only when no host C++
compiler is found; a build that fails raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
_SRC_DIR = _REPO / "native"
_SOURCES = ("lcp_dantzig.cpp", "aba.cpp")
_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")

_lib = None


def _compiler():
    return os.environ.get("CXX") or shutil.which("g++")


def build(force: bool = False) -> Path:
    """Compile the golden library if it is missing (or `force`); returns
    its path."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update((_SRC_DIR / s).read_bytes())
    out_dir = _REPO / "build" / "dartenv_tpu_torch" / (
        "native_" + h.hexdigest()[:16])
    path = out_dir / "libdartenv_native.so"
    if path.exists() and not force:
        return path
    cxx = _compiler()
    if not cxx:
        raise RuntimeError("native: no host C++ compiler (g++) found")
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libdartenv_native.so.tmp{os.getpid()}"
    proc = subprocess.run(
        [cxx, *_FLAGS, "-o", str(tmp)] + [str(_SRC_DIR / s)
                                          for s in _SOURCES],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native: {cxx} failed:\n{proc.stderr}")
    os.replace(tmp, path)
    return path


def lib() -> ctypes.CDLL:
    """The loaded golden library (built if needed)."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(str(build()))
        _declare(L)
        _lib = L
    return _lib


def available() -> bool:
    """Whether a host C++ compiler is there to build the goldens."""
    return _compiler() is not None


_D = ctypes.POINTER(ctypes.c_double)
_I = ctypes.POINTER(ctypes.c_int)


def _declare(L: ctypes.CDLL) -> None:
    L.dartenv_lcp_solve.restype = ctypes.c_int
    L.dartenv_lcp_solve.argtypes = [
        ctypes.c_int, _D, _D, _D, _D, _I, _D, _D, _D,
    ]
    L.dartenv_aba.restype = ctypes.c_int
    L.dartenv_aba.argtypes = (
        [ctypes.c_int, ctypes.c_int, _I, _I, _I, _I]
        + [_D] * 13                      # pj/cj frames, axes, inertials, q
        + [_D, _D]                       # dq, tau
        + [ctypes.c_double, _D, _D]      # dt, f_ext (nullable), ddq_out
    )


def _f64(a):
    if hasattr(a, "detach"):
        a = a.detach().cpu().double().numpy()
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64))


def _i32(a):
    return np.ascontiguousarray(np.asarray(a, dtype=np.int32))


def _dp(a):
    return a.ctypes.data_as(_D)


def _ip(a):
    return a.ctypes.data_as(_I)


def lcp_solve(A, b, lo, hi, findex=None, mu=None):
    """Golden boxed-LCP solve of one problem (Dantzig pivoting + the
    friction-bound fixed point), float64 on the host.  A (m, m), b, lo,
    hi, mu (m,) arrays or tensors; findex (m,) ints (-1: no friction
    coupling).  Returns (x, w, n_violations) as numpy."""
    L = lib()
    A, b, lo, hi = _f64(A), _f64(b), _f64(lo), _f64(hi)
    m = b.shape[0]
    if A.shape != (m, m) or lo.shape != (m,) or hi.shape != (m,):
        raise ValueError(f"lcp_solve: A {A.shape}, lo {lo.shape}, hi "
                         f"{hi.shape} for m = {m}")
    fi = _i32(findex if findex is not None else -np.ones(m))
    mu_a = _f64(mu if mu is not None else np.ones(m))
    x = np.zeros(m, dtype=np.float64)
    w = np.zeros(m, dtype=np.float64)
    bad = L.dartenv_lcp_solve(m, _dp(A), _dp(b), _dp(lo), _dp(hi), _ip(fi),
                              _dp(mu_a), _dp(x), _dp(w))
    return x, w, int(bad)


def aba(model, q, dq, tau, dt, f_ext_world=None):
    """Golden forward dynamics of one env of the port's SkelModel, float64
    on the host: q, dq, tau (n,), f_ext_world (nb, 6) [torque; force] in
    world coordinates at each body origin, or None.  Returns ddq (n,)
    numpy."""
    L = lib()
    n, nb = model.n, model.nb
    args = [_f64(getattr(model, f)) for f in (
        "pj_rot", "pj_pos", "cj_rot", "cj_pos", "axes", "mass", "com",
        "inertia", "damping", "spring_stiff", "rest_pos", "gravity")]
    q64, dq64, tau64 = _f64(q), _f64(dq), _f64(tau)
    for name, x in (("q", q64), ("dq", dq64), ("tau", tau64)):
        if x.shape != (n,):
            raise ValueError(f"aba: {name} {x.shape}, expected ({n},)")
    fext = None
    if f_ext_world is not None:
        fext = _f64(f_ext_world)
        if fext.shape != (nb, 6):
            raise ValueError(f"aba: f_ext_world {fext.shape}, expected "
                             f"({nb}, 6)")
    ints = [_i32(model.parent), _i32(model.joint_type), _i32(model.q_start),
            _i32(model.ndof)]
    ddq = np.zeros(n, dtype=np.float64)
    L.dartenv_aba(nb, n, *[_ip(a) for a in ints],
                  *[_dp(a) for a in args + [q64]], _dp(dq64), _dp(tau64),
                  ctypes.c_double(float(dt)),
                  _dp(fext) if fext is not None else None, _dp(ddq))
    return ddq
