"""The position update q_new = integrate(q, dq, dt) of a batch: the CUDA
kernel's wrapper and its dispatch.

`integrate` is what every substep calls (the fused phase, the phase-wise
step and the envelope hook alike).  It runs the kernel (csrc/integrate.cu:
one thread per env, every column of q_new, the exp-map of each BALL and
FREE joint included, in one launch with no host-side index) on a float32
CUDA batch of a model with a BALL or FREE joint.  Anything else runs the
plain version, dynamics/batched.integrate_positions, which is also the
tests' oracle: models without such joints (planar and revolute-only, where
the plain version is two ops), CPU batches and float64 batches.
`integrate_host` runs the kernel's per-env arithmetic built with the host
compiler (csrc/integrate_host.cpp), for tests without a GPU.

`INTEGRATE_LAUNCHES` counts kernel launches; `PLAIN_CALLS` counts runs of
the plain version through `integrate`.  `prepare(model)`, called where a
sim step or a fused phase is built, starts the kernel's compile early, so
that it runs beside the other kernels' builds.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.dynamics import batched
from dartenv_tpu_torch.model.skel_model import BALL, FREE, SkelModel

INTEGRATE_LAUNCHES = 0    # kernel launches
PLAIN_CALLS = 0           # plain-version runs through integrate

_BUILD = None
_LIB = None
_HOST_LIB = None
_TABLES: Dict[tuple, torch.Tensor] = {}   # (topology, device) -> table


def joint_table(model: SkelModel) -> np.ndarray:
    """(G, 2) int32: (q_start, is_free) of each BALL and FREE joint, the
    BALL joints first, in the plain version's order."""
    idx = batched.get_index(model)
    rows = [(int(idx.q_start[j]), int(t == FREE)) for t in (BALL, FREE)
            for j in idx.groups.get(t, ())]
    return np.asarray(rows, dtype=np.int32).reshape(-1, 2)


def has_rotations(model: SkelModel) -> bool:
    """Whether the model has a BALL or FREE joint."""
    groups = batched.get_index(model).groups
    return BALL in groups or FREE in groups


def _table(model: SkelModel, device) -> torch.Tensor:
    """The joint table on `device`, built once per topology and device."""
    key = (model.joint_type, model.q_start, device)
    if key not in _TABLES:
        _TABLES[key] = torch.as_tensor(joint_table(model), device=device)
    return _TABLES[key]


def start_build():
    """Start compiling the kernel, once a process (returns its
    cuda_build.Build)."""
    global _BUILD
    if _BUILD is None:
        _BUILD = cuda_build.start_build("dartenv_integrate", "integrate.cu",
                                        deps=("integrate_body.h",))
    return _BUILD


def prepare(model: SkelModel):
    """Start the kernel's build if the model's batches will run it (a
    float32 CUDA model with a BALL or FREE joint); load() waits for it."""
    if (model.device.type == "cuda" and model.dtype == torch.float32
            and has_rotations(model)):
        start_build()


def load():
    """Compile (if needed) and load the kernel library."""
    global _LIB
    if _LIB is None:
        lib = cuda_build.finish_build(start_build())
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.integrate_launch.argtypes = [vp] * 4 + [ci] * 3 + [
            ctypes.c_float, vp]
        lib.integrate_launch.restype = ci
        _LIB = lib
    return _LIB


def _check(model: SkelModel, q, dq, cuda: bool):
    """(B, n) of a batch the kernel takes; raises on anything else."""
    B, n = q.shape[0], model.n
    for name, x in (("q", q), ("dq", dq)):
        if (x.dtype != torch.float32 or x.shape != (B, n)
                or x.device != q.device or x.is_cuda != cuda):
            raise ValueError(
                f"integrate kernel: {name} must be a float32 "
                f"{'CUDA' if cuda else 'CPU'} tensor of shape {(B, n)}, got "
                f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return B, n


def integrate_cuda(model: SkelModel, q, dq, dt):
    """q_new (B, n) by one launch of the kernel on a float32 CUDA batch."""
    global INTEGRATE_LAUNCHES
    B, n = _check(model, q, dq, cuda=True)
    table = _table(model, q.device)
    lib = load()
    q, dq = q.contiguous(), dq.contiguous()
    out = torch.empty((B, n), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        code = lib.integrate_launch(q.data_ptr(), dq.data_ptr(),
                                    out.data_ptr(), table.data_ptr(),
                                    table.shape[0], B, n, float(dt), stream)
    cuda_build.check_launch(code, "integrate kernel")
    INTEGRATE_LAUNCHES += 1
    return out


def integrate_host(model: SkelModel, q, dq, dt):
    """The kernel's per-env arithmetic (csrc/integrate_body.h) built with
    the host C++ compiler and run on float32 CPU tensors, one env at a
    time.  For tests on machines without a GPU: nothing on the main path
    calls it, and it is not a stand-in for the kernel."""
    global _HOST_LIB
    if _HOST_LIB is None:
        lib = cuda_build.build_host("dartenv_integrate_host",
                                    "integrate_host.cpp",
                                    deps=("integrate_body.h",))
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.integrate_host.argtypes = [vp] * 4 + [ci] * 3 + [ctypes.c_float]
        lib.integrate_host.restype = ci
        _HOST_LIB = lib
    B, n = _check(model, q, dq, cuda=False)
    table = torch.as_tensor(joint_table(model))
    q, dq = q.contiguous(), dq.contiguous()
    out = torch.empty((B, n), dtype=torch.float32)
    _HOST_LIB.integrate_host(q.data_ptr(), dq.data_ptr(), out.data_ptr(),
                             table.data_ptr(), table.shape[0], B, n,
                             float(dt))
    return out


def integrate(model: SkelModel, q, dq, dt):
    """Batched semi-implicit position update (exp-map for BALL / FREE
    joints): the kernel on a float32 CUDA batch of a model with a BALL or
    FREE joint, else the plain version."""
    global PLAIN_CALLS
    if cuda_build.use_kernel(q) and has_rotations(model):
        return integrate_cuda(model, q, dq, dt)
    PLAIN_CALLS += 1
    return batched.integrate_positions(model, q, dq, dt)
