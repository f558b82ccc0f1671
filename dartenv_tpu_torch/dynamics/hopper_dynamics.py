"""The smooth-dynamics phase: the CUDA kernel's wrapper and its plain
PyTorch version.

(q, dq, tau) -> (dq_star, M, phi, R_w, p_w) for a batch: joint kinematics
of all ten joint types, tree recursion, world dof columns, mass matrix,
bias forces and the implicit spring/damping forward solve.  On a float32
CUDA batch `make_dynamics_phase` runs `DynamicsKernel` (csrc/dynamics.cu,
a group of `lane_group(model)` lanes per env); on a CPU or float64 batch
it runs `dynamics_reference` (dynamics/batched.bkin + forward_dynamics).
With `dr_fields` (a subset of DR_FIELDS_DYN) those model leaves are
per-env inputs (domain randomization): the kernel is built with a DR
layout (`dr_header`) and takes one (B, width) array per leaf; the plain
version takes the model with those leaves replaced by (B, ...) tensors.

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

# Model leaves the kernel takes as per-env inputs (domain randomization):
# the JAX kernel's DR_FIELDS_DYN, pure value data of the dynamics stage.
DR_FIELDS_DYN = ("mass", "com", "inertia", "damping", "spring_stiff",
                 "rest_pos", "gravity")


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


def dynamics_header(model: SkelModel, dr_fields=()) -> str:
    """The C header that fixes csrc/dynamics_body.h to one model: sizes,
    dt, the mask of joint types and the lane group as macros, the tables
    (topology and its tree levels, the (body, dof) columns and the
    mass-matrix entries the lanes take, joint frames, axes, inertias,
    gravity, springs and dampers) as DY_CONST arrays (__constant__ under
    nvcc, static const in a host build), then the DR layout of
    `dr_fields` (`dr_header`)."""
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
    out.append(dr_header(model, dr_fields))
    return "".join(out)


def dr_layout(model: SkelModel, dr_fields):
    """[(field, offset, width)] of an env's DR block: the fields in the
    given order, each the model leaf flattened row-major (mass nb, com
    3 nb, inertia 9 nb, damping / spring_stiff / rest_pos n, gravity 3,
    geom_friction / geom_restitution ng, geom_size 3 ng, wg_friction /
    wg_restitution nw)."""
    out, off = [], 0
    for f in dr_fields:
        w = int(getattr(model, f).numel())
        out.append((f, off, w))
        off += w
    return out


def dr_header(model: SkelModel, dr_fields) -> str:
    """The DR layout of a kernel build (csrc/dynamics_body.h's
    accessors): DR_F floats per env and DR_NF leaves, DR_HAS_<LEAF> and
    DR_O_<LEAF> per leaf, the widths and offsets as DY_CONST tables.
    Empty without DR fields, so a build without them is the same as
    before DR inputs existed."""
    if not dr_fields:
        return ""
    lay = dr_layout(model, dr_fields)
    out = [f"#define DR_F {sum(w for _, _, w in lay)}\n",
           f"#define DR_NF {len(lay)}\n"]
    for f, o, _ in lay:
        out += [f"#define DR_HAS_{f.upper()} 1\n",
                f"#define DR_O_{f.upper()} {o}\n"]
    out += [c_ints("c_dr_w", [w for _, _, w in lay]),
            c_ints("c_dr_o", [o for _, o, _ in lay])]
    return "".join(out)


def dr_inputs(model: SkelModel, dr_fields, dr_vals, B: int, device,
              what: str):
    """The DR leaves as the kernels take them: one contiguous float32
    (B, width) tensor per leaf on `device`, from (B, ...) values (the
    model leaf's shape with a leading env axis)."""
    if len(dr_vals) != len(dr_fields):
        raise ValueError(f"{what}: {len(dr_fields)} DR leaves "
                         f"{tuple(dr_fields)}, got {len(dr_vals)} values")
    out = []
    for (f, _, w), v in zip(dr_layout(model, dr_fields), dr_vals):
        if (v.dtype != torch.float32 or v.device != torch.device(device)
                or v.shape[0] != B or v[0].numel() != w):
            raise ValueError(
                f"{what}: DR leaf {f} must be a float32 tensor of {B} envs "
                f"x {w} values on {device}, got {v.dtype} "
                f"{tuple(v.shape)} on {v.device}")
        out.append(v.reshape(B, w).contiguous())
    return out


def c_ptrs(xs):
    """A C array of the tensors' data pointers (at least one entry)."""
    return (ctypes.c_void_p * max(1, len(xs)))(*[x.data_ptr() for x in xs])


def with_leaves(model: SkelModel, dr_fields, dr_vals) -> SkelModel:
    """The model with the DR leaves replaced by their per-env values
    ((B, ...) tensors), as the plain versions take it."""
    if not dr_fields:
        return model
    return model.replace(**{
        f: v.reshape((v.shape[0],) + tuple(getattr(model, f).shape))
        for f, v in zip(dr_fields, dr_vals)})


# ---------------------------------------------------------------------------
# the CUDA kernel: build, launch wrapper, host build
# ---------------------------------------------------------------------------

class DynamicsKernel:
    """The dynamics kernel built for one model digest and DR field set
    (a subset of DR_FIELDS_DYN, each leaf then a per-env input)."""

    def __init__(self, model: SkelModel, dr_fields=()):
        if model.nb < 1:
            raise ValueError("the dynamics kernel needs at least one body")
        bad = [f for f in dr_fields if f not in DR_FIELDS_DYN]
        if bad:
            raise ValueError(f"the dynamics kernel takes no per-env {bad}; "
                             f"its DR leaves are {DR_FIELDS_DYN}")
        self.model = model
        self.n, self.nb = model.n, model.nb
        self.dr_fields = tuple(dr_fields)
        self.dr_width = sum(w for _, _, w in dr_layout(model, dr_fields))
        self.group = lane_group(model)
        self._header = dynamics_header(model, self.dr_fields)
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
            lib.dynamics_launch.argtypes = [vp] * 9 + [ci, vp]
            lib.dynamics_launch.restype = ci
            self._check_dims(lib)
            self._lib = lib
        return self._lib

    def _check_dims(self, lib):
        dims = (ctypes.c_int * 4)()
        lib.dynamics_dims(dims)
        want = [self.n, self.nb, self.group, self.dr_width]
        if list(dims) != want:
            raise RuntimeError(
                f"dynamics kernel built for sizes {list(dims)}, the model "
                f"needs {want}")

    def run_host(self, q, dq, tau, *dr_vals):
        """The kernel's per-env arithmetic (csrc/dynamics_body.h) built
        with the host C++ compiler and run as a loop over envs on float32
        CPU tensors.  For tests on machines without a GPU: nothing on the
        main path calls it, and it is not a stand-in for the kernel."""
        if self._host_lib is None:
            lib = cuda_build.build_host(
                "dartenv_dynamics_host", "dynamics_host.cpp",
                header_text=self._header, header_name="dynamics_model.h",
                deps=("dynamics_body.h",))
            lib.dynamics_host.argtypes = [ctypes.c_void_p] * 9 + [
                ctypes.c_int]
            lib.dynamics_host.restype = ctypes.c_int
            self._check_dims(lib)
            self._host_lib = lib
        ins = [x.to(torch.float32).contiguous() for x in (q, dq, tau)]
        if any(x.is_cuda for x in ins):
            raise ValueError("run_host takes CPU tensors")
        B = q.shape[0]
        dr = dr_inputs(self.model, self.dr_fields,
                       [v.to(torch.float32) for v in dr_vals], B, "cpu",
                       "dynamics host build")
        outs = self._outputs(B, "cpu")
        self._host_lib.dynamics_host(*[x.data_ptr() for x in ins],
                                     *[x.data_ptr() for x in outs],
                                     c_ptrs(dr), B)
        return tuple(outs)

    def __call__(self, q, dq, tau, *dr_vals):
        """q, dq, tau: (B, n) float32 CUDA tensors; dr_vals: the values of
        the DR leaves, (B, ...) float32 on the same device.  Returns
        (dq_star, M, phi, R_w, p_w) as dynamics_reference does."""
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
        dr = dr_inputs(self.model, self.dr_fields, dr_vals, B, dev,
                       "dynamics kernel")
        if dev.index != torch.cuda.current_device():
            with torch.cuda.device(dev):
                return self(q, dq, tau, *dr_vals)
        lib = self._lib or self.load()
        outs = self._outputs(B, dev)
        if B == 0:
            return tuple(outs)
        ins = [x if x.is_contiguous() else x.contiguous()
               for x in (q, dq, tau)]
        code = lib.dynamics_launch(
            *[x.data_ptr() for x in ins], *[x.data_ptr() for x in outs],
            c_ptrs(dr), B, torch.cuda.current_stream().cuda_stream)
        cuda_build.check_launch(code, "dynamics kernel")
        DYNAMICS_LAUNCHES += 1
        return tuple(outs)


_KERNELS: Dict[str, DynamicsKernel] = {}


def get_dynamics_kernel(model: SkelModel, dr_fields=()) -> DynamicsKernel:
    """The (cached) kernel object for this model's digest and DR fields."""
    k = DynamicsKernel(model, dr_fields)
    return _KERNELS.setdefault(k._header, k)


def make_dynamics_phase(model: SkelModel, dr_fields=()):
    """dyn(q, dq, tau, *dr_vals) -> (dq_star, M, phi, R_w, p_w) for a
    batch, or None for a model the kernel cannot serve (no bodies) or a
    DR field outside DR_FIELDS_DYN.  dr_vals: the per-env values of the
    `dr_fields` leaves, (B, ...) tensors; `model` is the base model, whose
    values of those leaves are ignored.  A float32 CUDA batch runs the
    dynamics kernel; a CPU or float64 batch runs dynamics_reference on the
    model with the per-env leaves."""
    dr_fields = tuple(dr_fields)
    if model.nb < 1 or any(f not in DR_FIELDS_DYN for f in dr_fields):
        return None
    kernel: list = [None]

    def dyn(q, dq, tau, *dr_vals):
        global PLAIN_CALLS
        if cuda_build.use_kernel(q):
            if kernel[0] is None:
                kernel[0] = get_dynamics_kernel(model, dr_fields)
            return kernel[0](q, dq, tau, *dr_vals)
        PLAIN_CALLS += 1
        return dynamics_reference(with_leaves(model, dr_fields, dr_vals), q,
                                  dq, tau)

    return dyn
