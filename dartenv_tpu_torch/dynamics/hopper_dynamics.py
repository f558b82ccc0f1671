"""The smooth-dynamics phase: the CUDA kernel's wrapper and its plain
PyTorch version.

(q, dq, tau) -> (dq_star, M, phi, R_w, p_w) for a batch: joint kinematics
of all ten joint types, tree recursion, world dof columns, mass matrix,
bias forces and the implicit spring/damping forward solve.  On a float32
CUDA batch `make_dynamics_phase` runs `DynamicsKernel` (csrc/dynamics.cu,
a group of `lane_group(model)` lanes per env); on a CPU or float64 batch
it runs `dynamics_reference` (dynamics/batched.bkin + forward_dynamics).

`DYNAMICS_LAUNCHES` counts kernel launches; `PLAIN_CALLS` counts runs of
the plain version through the phase (so a run can show it took none).
`dynamics_header` generates the model tables that the kernel, and the
dynamics stage of the fused substep kernel, are compiled with.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.dynamics import batched
from dartenv_tpu_torch.model.skel_model import SkelModel

DYNAMICS_LAUNCHES = 0     # launches of the dynamics kernel
PLAIN_CALLS = 0           # calls of dynamics_reference through the phase

_OUTS = ("dq_star", "M", "phi", "R_w", "p_w")


def dynamics_reference(model: SkelModel, q, dq, tau):
    """The plain version: batched.bkin + forward_dynamics.  q, dq, tau:
    (B, n), any dtype, any device.  Returns (dq_star (B, n), M (B, n, n),
    phi (B, n, 6), R_w (B, nb, 3, 3), p_w (B, nb, 3))."""
    dt = model.dt
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt)
    return dq + dt * ddq, M, kin.phi, kin.R_w, kin.p_w


# ---------------------------------------------------------------------------
# generated model header
# ---------------------------------------------------------------------------

def c_floats(name: str, vals) -> str:
    """A DY_CONST float array definition of `vals` (at least one entry)."""
    vals = np.asarray(vals, dtype=np.float64).reshape(-1)
    body = ", ".join(f"{np.float32(v):.9e}f" for v in vals) or "0.0f"
    return (f"DY_CONST float {name}[{max(1, vals.size)}] = "
            f"{{{body}}};\n")


def c_ints(name: str, vals) -> str:
    """A DY_CONST int array definition of `vals` (at least one entry)."""
    vals = np.asarray(vals, dtype=np.int64).reshape(-1)
    body = ", ".join(str(int(v)) for v in vals) or "0"
    return f"DY_CONST int {name}[{max(1, vals.size)}] = {{{body}}};\n"


def c_float(v) -> str:
    return f"{np.float32(v):.9e}f"


def lane_group(model: SkelModel) -> int:
    """Lanes per env of the dynamics stage: the smallest power of two >=
    max(nb, n), at most a warp (cartpole 2, walker2d 16)."""
    g = 1
    while g < max(model.nb, model.n) and g < 32:
        g *= 2
    return g


def depth_levels(parent) -> list:
    """Bodies by tree depth, each level in index order (a parent precedes
    its children in the model)."""
    depth = []
    for b, p in enumerate(parent):
        depth.append(0 if p < 0 else depth[p] + 1)
    return [[b for b, d in enumerate(depth) if d == lv]
            for lv in range(max(depth) + 1)] if depth else []


def dynamics_header(model: SkelModel) -> str:
    """The C header that fixes csrc/dynamics_body.h to one model: sizes,
    dt, the mask of joint types and the lane group as macros, the tables
    (topology and its tree levels, the (body, dof) columns and the
    mass-matrix entries the lanes take, joint frames, axes, inertias,
    gravity, springs and dampers) as DY_CONST arrays (__constant__ under
    nvcc, static const in a host build)."""
    h = model.host
    n, nb = model.n, model.nb
    mask = 0
    for t in set(model.joint_type):
        mask |= 1 << int(t)
    anc = h("ancestor_mask") > 0.5
    levels = depth_levels(model.parent)
    fcols = [(b, j) for b in range(nb) for j in range(n) if anc[b, j]]
    pairs = [(i, j) for j in range(n) for i in range(j + 1)]
    out = ["// generated from the model's static digest; do not edit\n",
           "#pragma once\n",
           "#ifndef DY_CONST\n#define DY_CONST __constant__\n#endif\n"]
    defs = dict(DY_N=n, DY_NB=nb, DY_MAXDOF=max(1, max(model.ndof)),
                DY_JMASK=mask, DY_DT=c_float(model.dt),
                DY_G=lane_group(model), DY_NLEVEL=len(levels),
                DY_NF=len(fcols), DY_NPAIR=len(pairs))
    out += [f"#define {k} {v}\n" for k, v in defs.items()]
    cj_rot, cj_pos = h("cj_rot"), h("cj_pos")
    axes = h("axes")
    norms = np.linalg.norm(axes, axis=-1)
    unit = np.where(norms[..., None] < 1e-12, 0.0,
                    axes / np.maximum(norms[..., None], 1e-300))
    norms = np.where(norms < 1e-12, 0.0, norms)
    out += [
        c_ints("c_parent", model.parent), c_ints("c_jt", model.joint_type),
        c_ints("c_qstart", model.q_start), c_ints("c_ndof", model.ndof),
        c_ints("c_dof_body", model.dof_body_index()),
        c_ints("c_anc", anc),
        c_ints("c_lvl_start", np.cumsum([0] + [len(lv) for lv in levels])),
        c_ints("c_lvl_body", [b for lv in levels for b in lv]),
        c_ints("c_f_body", [b for b, _ in fcols]),
        c_ints("c_f_dof", [j for _, j in fcols]),
        c_ints("c_pair_i", [i for i, _ in pairs]),
        c_ints("c_pair_j", [j for _, j in pairs]),
        c_floats("c_pj_rot", h("pj_rot")), c_floats("c_pj_pos", h("pj_pos")),
        c_floats("c_cj_rot", cj_rot), c_floats("c_cj_pos", cj_pos),
        # inv(T_cj) applied on the right: R_rel = R1 cj_rot^T,
        # p_rel = p1 + R1 (-cj_rot^T cj_pos)
        c_floats("c_cji_rot", np.swapaxes(cj_rot, -1, -2)),
        c_floats("c_cji_pos", -np.einsum("bji,bj->bi", cj_rot, cj_pos)),
        c_floats("c_axes", axes), c_floats("c_axes_unit", unit),
        c_floats("c_axes_norm", norms),
        c_floats("c_mass", h("mass")), c_floats("c_com", h("com")),
        c_floats("c_inertia", h("inertia")),
        c_floats("c_gravity", h("gravity")),
        c_floats("c_damping", h("damping")),
        c_floats("c_spring", h("spring_stiff")),
        c_floats("c_rest", h("rest_pos")),
    ]
    return "".join(out)


# ---------------------------------------------------------------------------
# the CUDA kernel: build, launch wrapper, host build
# ---------------------------------------------------------------------------

class DynamicsKernel:
    """The dynamics kernel built for one model digest."""

    def __init__(self, model: SkelModel):
        if model.nb < 1:
            raise ValueError("the dynamics kernel needs at least one body")
        self.n, self.nb = model.n, model.nb
        self.group = lane_group(model)
        self._header = dynamics_header(model)
        self._build = None
        self._lib = None
        self._host_lib = None
        # per-env widths of the five outputs, in the packed buffer's order
        n, nb = self.n, self.nb
        self._widths = (n, n * n, 6 * n, 9 * nb, 3 * nb)
        self._tails = ((n,), (n, n), (n, 6), (nb, 3, 3), (nb, 3))

    def shapes(self, B: int):
        return {k: (B, *t) for k, t in zip(_OUTS, self._tails)}

    def _outputs(self, B: int, device):
        """One allocation; each output a contiguous view of it."""
        buf = torch.empty((B * sum(self._widths),), dtype=torch.float32,
                          device=device)
        outs, a = [], 0
        for w, t in zip(self._widths, self._tails):
            outs.append(buf[a:a + B * w].view(B, *t))
            a += B * w
        return outs

    def start_build(self):
        if self._build is None:
            self._build = cuda_build.start_build(
                "dartenv_dynamics", "dynamics.cu", header_text=self._header,
                header_name="dynamics_model.h", deps=("dynamics_body.h",))
        return self._build

    def load(self):
        if self._lib is None:
            lib = cuda_build.finish_build(self.start_build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.dynamics_launch.argtypes = [vp] * 8 + [ci, vp]
            lib.dynamics_launch.restype = ci
            self._check_dims(lib)
            self._lib = lib
        return self._lib

    def _check_dims(self, lib):
        dims = (ctypes.c_int * 3)()
        lib.dynamics_dims(dims)
        if list(dims) != [self.n, self.nb, self.group]:
            raise RuntimeError(
                f"dynamics kernel built for sizes {list(dims)}, the model "
                f"needs {[self.n, self.nb, self.group]}")

    def run_host(self, q, dq, tau):
        """The kernel's per-env arithmetic (csrc/dynamics_body.h) built
        with the host C++ compiler and run as a loop over envs on float32
        CPU tensors.  For tests on machines without a GPU: nothing on the
        main path calls it, and it is not a stand-in for the kernel."""
        if self._host_lib is None:
            lib = cuda_build.build_host(
                "dartenv_dynamics_host", "dynamics_host.cpp",
                header_text=self._header, header_name="dynamics_model.h",
                deps=("dynamics_body.h",))
            lib.dynamics_host.argtypes = [ctypes.c_void_p] * 8 + [
                ctypes.c_int]
            lib.dynamics_host.restype = ctypes.c_int
            self._check_dims(lib)
            self._host_lib = lib
        ins = [x.to(torch.float32).contiguous() for x in (q, dq, tau)]
        if any(x.is_cuda for x in ins):
            raise ValueError("run_host takes CPU tensors")
        B = q.shape[0]
        outs = self._outputs(B, "cpu")
        self._host_lib.dynamics_host(*[x.data_ptr() for x in ins],
                                     *[x.data_ptr() for x in outs], B)
        return tuple(outs)

    def __call__(self, q, dq, tau):
        """q, dq, tau: (B, n) float32 CUDA tensors.  Returns (dq_star, M,
        phi, R_w, p_w) as dynamics_reference does."""
        global DYNAMICS_LAUNCHES
        B, dev = q.shape[0], q.device
        want = (B, self.n)
        for name, x in (("q", q), ("dq", dq), ("tau", tau)):
            if (x.dtype != torch.float32 or x.shape != want
                    or x.device != dev or not x.is_cuda):
                raise ValueError(
                    f"dynamics kernel: {name} must be a float32 CUDA tensor "
                    f"of shape {want}, got {x.dtype} {tuple(x.shape)} on "
                    f"{x.device}")
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(q, dq, tau)
        lib = self._lib or self.load()
        outs = self._outputs(B, dev)
        if B == 0:
            return tuple(outs)
        ins = [x if x.is_contiguous() else x.contiguous()
               for x in (q, dq, tau)]
        code = lib.dynamics_launch(
            *[x.data_ptr() for x in ins], *[x.data_ptr() for x in outs], B,
            torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(code, "dynamics kernel")
        DYNAMICS_LAUNCHES += 1
        return tuple(outs)


_KERNELS: Dict[str, DynamicsKernel] = {}


def get_dynamics_kernel(model: SkelModel) -> DynamicsKernel:
    """The (cached) kernel object for this model's digest."""
    k = DynamicsKernel(model)
    return _KERNELS.setdefault(k._header, k)


def make_dynamics_phase(model: SkelModel):
    """dyn(q, dq, tau) -> (dq_star, M, phi, R_w, p_w) for a batch, or None
    for a model the kernel cannot serve (no bodies).  A float32 CUDA batch
    runs the dynamics kernel; a CPU or float64 batch runs
    dynamics_reference."""
    if model.nb < 1:
        return None
    kernel: list = [None]

    def dyn(q, dq, tau):
        global PLAIN_CALLS
        if cuda_build.use_kernel(q):
            if kernel[0] is None:
                kernel[0] = get_dynamics_kernel(model)
            return kernel[0](q, dq, tau)
        PLAIN_CALLS += 1
        return dynamics_reference(model, q, dq, tau)

    return dyn

