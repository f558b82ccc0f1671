"""The fused physics substep: the CUDA kernel's wrapper, its plain PyTorch
version, and the hybrid exact-escalation stage around them.

One substep of a batch is

  1. the fused substep (`SubstepKernel` -> csrc/substep.cu on a float32 CUDA
     batch; `substep_reference` on a CPU or float64 batch): dynamics ->
     halfspace collision -> active-set compaction -> contact / limit /
     dof-friction rows -> A = J M^-1 J^T + cfm -> warm-started PGS ->
     normalized residual -> dq_plus, lam_full, packed `esc`;
  2. `escalate_batch`: the worst K = min(B, kmax, ceil(frac * B)) envs by
     residual are re-solved exactly and patched (`escalation_size` and
     `keep_best` of lcp/hybrid): on a float32 CUDA batch a top-K and ONE
     launch of the escalation kernel's fused mode (lcp/hopper_bpp.
     bpp_fused), otherwise its plain version `escalate_reference`;
  3. the position update, dynamics/hopper_integrate.integrate (one launch
     of the position-update kernel on a float32 CUDA batch of a model with
     a BALL or FREE joint, otherwise batched.integrate_positions).

Scope of the fused path (as in the JAX package): world pairs of sphere /
capsule / box against a halfspace, no self pairs, no servo rows, at least
one constraint row.  The CUDA kernel takes all ten joint types.  The
escalation runs the exact tiers and then, with SolverConfig.escalate_ref64
> 0, the mixed-precision refinement tier (lcp/dantzig.refine_mixed), else
with escalate_ref > 0 the compensated one (lcp/dantzig.refine_compensated).

Domain randomization: with `dr_fields` (a subset of DR_FIELDS_SUB) those
model leaves are per-env inputs, (B, ...) values passed after tau; the
kernel is built with a DR layout (one build per field set) and the plain
version runs on the model with those leaves replaced by the per-env
values.  The escalation takes none: it rebuilds from the substep's M, Jc,
b and mu, which the DR leaves have already shaped.

`SUBSTEP_LAUNCHES` counts kernel launches; `PLAIN_CALLS` counts runs of
the plain version (so a run can show it took none).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional

import numpy as np
import torch

from dartenv_tpu_torch import cuda_build
from dartenv_tpu_torch.collision.narrowphase import Contacts, collide
from dartenv_tpu_torch.dynamics import batched, hopper_integrate
from dartenv_tpu_torch.dynamics.hopper_dynamics import (
    DR_FIELDS_DYN, c_ptrs, c_float, c_floats, c_ints, dr_inputs, dr_layout,
    dynamics_header, with_leaves,
)
from dartenv_tpu_torch.engine.constraints import (
    assemble_lcp, build_layout, compact_lam, compacted_findex,
    has_servo_rows, scatter_lam,
)
from dartenv_tpu_torch.lcp import hopper_bpp
from dartenv_tpu_torch.lcp.hybrid import (
    comp_residual, escalation_size, keep_best,
)
from dartenv_tpu_torch.lcp.pgs import pgs_solve
from dartenv_tpu_torch.math.linalg import (
    _UNROLL_MAX, chol, chol_solve, inv_psd, seq_mm, seq_mv,
)
from dartenv_tpu_torch.model.skel_model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_SPHERE, JOINT_NAMES, SkelModel,
)
from dartenv_tpu_torch.utils.span import span

SUBSTEP_LAUNCHES = 0      # launches of the fused substep kernel
PLAIN_CALLS = 0           # calls of substep_reference through the phase


KERNEL_JOINTS = tuple(sorted(JOINT_NAMES))      # all ten joint types
_NSLOTS = {GEOM_SPHERE: 1, GEOM_CAPSULE: 2, GEOM_BOX: 4}

_OUT_FIELDS = ("dq_plus", "lam_full", "res", "overflow", "con_pos",
               "con_depth", "con_active", "esc")

# Model leaves the substep kernel takes as per-env inputs (the JAX kernel's
# DR_FIELDS_SUB): the dynamics kernel's and the contact values its
# collision and row stages read.  Layout leaves stay static.
DR_FIELDS_SUB = DR_FIELDS_DYN + (
    "geom_friction", "geom_restitution", "wg_friction", "wg_restitution",
    "geom_size",
)


def in_fused_scope(model: SkelModel) -> bool:
    """Can the fused substep path (kernel or plain) serve this model?"""
    if model.nb < 1 or model.self_pairs or has_servo_rows(model):
        return False
    for gi, _ in model.world_pairs:
        if int(model.geom_type[gi]) not in _NSLOTS:
            return False
    return build_layout(model).m > 0


def unsupported_joints(model: SkelModel) -> List[str]:
    """Names of the model's joint types the CUDA kernel does not take."""
    return sorted({JOINT_NAMES[t] for t in model.joint_type
                   if t not in KERNEL_JOINTS})


def substep_supported(model: SkelModel) -> bool:
    """Can the CUDA substep kernel serve this model?"""
    return in_fused_scope(model) and not unsupported_joints(model)


class _SubStatic:
    """Static digest of a model for the fused substep: sizes, constraint
    layout, per-geom contact tables (float64 numpy, host side)."""

    def __init__(self, model: SkelModel):
        self.layout = build_layout(model)
        self.cfg = model.solver
        self.dt = float(model.dt)
        self.n, self.nb = model.n, model.nb
        h = model.host
        self.slots: List[dict] = []
        for gi, wi in model.world_pairs:
            t = int(model.geom_type[gi])
            n = h("wg_normal")[wi]
            ref = (np.array([1.0, 0, 0]) if abs(n[0]) < 0.9
                   else np.array([0.0, 0, 1.0]))
            t1 = np.cross(n, ref)
            t1 = t1 / np.linalg.norm(t1)
            self.slots.append(dict(
                gtype=t, body=int(model.geom_body[gi]), gi=int(gi),
                wi=int(wi), rot=h("geom_rot")[gi], pos=h("geom_pos")[gi],
                size=h("geom_size")[gi], n=n, off=float(h("wg_offset")[wi]),
                fric=min(float(h("geom_friction")[gi]),
                         float(h("wg_friction")[wi])),
                rest=max(float(h("geom_restitution")[gi]),
                         float(h("wg_restitution")[wi])),
                t1=t1, t2=np.cross(n, t1), nslots=_NSLOTS[t],
            ))
        self.ns = sum(d["nslots"] for d in self.slots)
        assert self.ns == self.layout.contact_slots
        self.cap = int(self.cfg.contact_cap)
        self.compact = 0 < self.cap < self.ns
        if not self.compact:
            self.cap = self.ns
        self.m_c = 3 * self.cap + (self.layout.m - 3 * self.ns)
        self.findex_c = (compacted_findex(self.layout, self.cap)
                         if self.ns else np.asarray(self.layout.findex))

    @functools.cached_property
    def escalation_header(self) -> str:
        """The generated header of the escalation kernel's fused mode
        (csrc/bpp.cu + escalate_body.h) for this digest: the sizes, cfm
        and the offsets of `esc`'s blocks (`_esc_layout`) as constants."""
        tab, width = _esc_layout(self)
        refc, ref64 = self.ref_passes
        defs = dict(ES_M=self.m_c, ES_N=self.n, ES_CAP=self.cap,
                    ES_NS=self.ns, ES_MFULL=self.layout.m,
                    ES_CFM=c_float(self.cfg.cfm), ES_W=width,
                    ES_REFC=refc, ES_REF64=ref64)
        names = dict(b="B", lo="LO", hi="HI", mu="MU", act="ACT",
                     lam_c="LAM", sel_slots="SEL", M="M", Jc="JC")
        defs.update({f"ES_O_{names[k]}": a for k, (a, _) in tab.items()})
        return "".join(f"#define {k} {v}\n" for k, v in defs.items())

    @property
    def ref_passes(self):
        """(compensated, mixed-precision) refinement passes of the
        escalation: SolverConfig.escalate_ref and escalate_ref64, the
        latter winning where both are set."""
        return hopper_bpp.ref_tiers(self.cfg.escalate_ref,
                                    self.cfg.escalate_ref64)

    @property
    def escalation_dims(self):
        """(n, m_c, m, esc width, compensated passes, float64 passes), as
        lcp/hopper_bpp.bpp_fused takes them."""
        return (self.n, self.m_c, self.layout.m, _esc_layout(self)[1],
                *self.ref_passes)


def _esc_layout(st: _SubStatic):
    """Slice table of the packed `esc` buffer: name -> (start, stop)."""
    n, m_c, cap = st.n, st.m_c, st.cap
    sizes = (("b", m_c), ("lo", m_c), ("hi", m_c), ("mu", m_c),
             ("act", m_c), ("lam_c", m_c),
             ("sel_slots", cap), ("M", n * n), ("Jc", m_c * n))
    off, table = 0, {}
    for name, k in sizes:
        table[name] = (off, off + k)
        off += k
    return table, off


def unpack_esc(st: _SubStatic, esc) -> Dict[str, torch.Tensor]:
    """The named blocks of a packed `esc` tensor (..., width): views."""
    tab, _ = _esc_layout(st)
    return {name: esc[..., a:b] for name, (a, b) in tab.items()}


def output_blocks(st: _SubStatic, outs) -> Dict[str, torch.Tensor]:
    """The substep's outputs with `esc` replaced by its named blocks, so
    that two versions can be compared block by block (the bounds lo / hi
    hold 1e20 and would hide every other block behind one norm)."""
    blocks = {f: outs[f] for f in _OUT_FIELDS if f != "esc"}
    blocks.update(unpack_esc(st, outs["esc"]))
    return blocks


# shared memory of one Hopper block that a kernel may opt in to, and of
# one SM (each resident block also reserves 1 KB of it)
SMEM_BLOCK_OPTIN = 232448
SMEM_PER_SM = 233472
MAX_ENVS_PER_BLOCK = 16


def smem_floats(st: _SubStatic, dr_width: int = 0) -> int:
    """Floats of kernel 1's per-env working set in shared memory: SS_SMEM
    of csrc/substep_body.h (its layout macros), which static_asserts that
    the two agree; dr_width: the floats of the env's DR block."""
    n, nb, cap = st.n, st.nb, max(1, st.cap)
    ns, mc = max(1, st.ns), max(1, st.m_c)
    return (_esc_layout(st)[1] + 10 * n + n * n + 12 * nb + 8 * ns
            + mc * (n + (mc | 1)) + cap + dr_width)


def launch_shape(st: _SubStatic, dr_width: int = 0):
    """(envs per block, min blocks per SM) of kernel 1 for this digest:
    the most envs (one warp each, at most MAX_ENVS_PER_BLOCK, and at most
    32 because the dynamics stage takes one lane of warp 0 per env) whose
    working sets fit in the shared memory a block may opt in to; two
    blocks per SM (the 64-register launch bound) where two such blocks fit
    on an SM, else one.  Walker2d and hopper: (16, 2).  dr_width: the
    floats of an env's DR block, part of its working set."""
    per_env = 4 * smem_floats(st, dr_width)
    warps = min(MAX_ENVS_PER_BLOCK, 32, SMEM_BLOCK_OPTIN // per_env)
    if warps < 1:
        raise NotImplementedError(
            f"kernel 1's working set of one env ({per_env} bytes) exceeds "
            f"a block's shared memory")
    blocks = 2 if 2 * (warps * per_env + 1024) <= SMEM_PER_SM else 1
    return warps, blocks


def _out_sizes(st: _SubStatic) -> Dict[str, int]:
    return dict(dq_plus=st.n, lam_full=st.layout.m, res=1, overflow=1,
                con_pos=3 * st.ns, con_depth=st.ns, con_active=st.ns,
                esc=_esc_layout(st)[1])


# ---------------------------------------------------------------------------
# the plain PyTorch version
# ---------------------------------------------------------------------------

def substep_reference(model: SkelModel, st: _SubStatic, q, dq, tau,
                      lam_prev):
    """The fused substep as plain batched tensor code: the composition of
    dynamics/batched, collision/narrowphase, engine/constraints and
    lcp/pgs, plus the residual, the selected-slot table and the `esc`
    packing.  q, dq, tau: (B, n); lam_prev: (B, m).  Any dtype, any device.

    Returns the kernel's eight outputs ((B, k) tensors, `_out_sizes`) and,
    for tests, the intermediate fields dq_star, b, lo, hi, mu, act, lam_c,
    sel_slots, M, Jc."""
    B = q.shape[0]
    dt, cfg, layout = st.dt, st.cfg, st.layout
    kin = batched.bkin(model, q, dq)
    ddq, M = batched.forward_dynamics(model, kin, q, dq, tau, dt)
    dq_star = dq + dt * ddq
    contacts = collide(model, kin.R_w, kin.p_w)
    A, b, lo, hi, act, mu, findex, MinvJt, row_sel, Jc = assemble_lcp(
        model, layout, kin.phi, M, q, dq, dq_star, contacts, dt)
    lam0 = compact_lam(lam_prev, row_sel, act)
    lam = pgs_solve(A, b, lo, hi, findex, mu, act, iters=cfg.pgs_iters,
                    omega=cfg.pgs_omega, lam0=lam0)
    res = comp_residual(A, b, lam, lo, hi, findex, mu, act)
    dq_plus = dq_star + torch.sum(MinvJt * lam[:, None, :], dim=-1)
    lam_full = scatter_lam(lam, row_sel, layout.m)
    if row_sel is not None:
        sel_slots = (row_sel[:, 0:3 * st.cap:3] // 3).to(q.dtype)
    else:
        sel_slots = torch.arange(st.cap, device=q.device,
                                 dtype=q.dtype).expand(B, st.cap)
    esc = torch.cat([b, lo, hi, mu, act, lam, sel_slots,
                     M.reshape(B, -1), Jc.reshape(B, -1)], dim=1)
    return dict(
        dq_plus=dq_plus, lam_full=lam_full, res=res[:, None],
        overflow=contacts.overflow[:, None],
        con_pos=contacts.pos.reshape(B, -1), con_depth=contacts.depth,
        con_active=contacts.active, esc=esc,
        dq_star=dq_star, b=b, lo=lo, hi=hi, mu=mu, act=act, lam_c=lam,
        sel_slots=sel_slots, M=M.reshape(B, -1), Jc=Jc.reshape(B, -1),
    )


# ---------------------------------------------------------------------------
# the CUDA kernel: generated model header, build, launch wrapper
# ---------------------------------------------------------------------------

def model_header(model: SkelModel, st: _SubStatic, dr_fields=()) -> str:
    """The C header that fixes csrc/substep.cu to one model: the dynamics
    stage's sizes and tables (dynamics/hopper_dynamics.dynamics_header,
    with the DR layout of `dr_fields`), then the launch shape
    (`launch_shape`), the substep's sizes and solver constants as macros
    and its contact, limit and friction tables as DY_CONST arrays
    (__constant__ under nvcc, static const in the host build); with DR
    fields also each world pair's geom and world-geom index and the
    unfolded friction and restitution of both sides."""
    bad = unsupported_joints(model)
    if bad:
        raise NotImplementedError(
            "the CUDA substep kernel does not take joint type(s) "
            + ", ".join(bad))
    h = model.host
    cfg, dt, n, nb = st.cfg, st.dt, st.n, st.nb
    lay = st.layout
    damping, spring = h("damping"), h("spring_stiff")
    f = c_float
    dr_width = sum(w for _, _, w in dr_layout(model, dr_fields))
    warps, blocks = launch_shape(st, dr_width)
    # per-env damping or springs are not known when the kernel is built:
    # the implicit factor is then always on
    implicit = (bool(np.any(damping != 0) or np.any(spring != 0))
                or "damping" in dr_fields or "spring_stiff" in dr_fields)
    defs = dict(
        SS_WARPS=warps, SS_MIN_BLOCKS=blocks,
        SS_SMEM_FLOATS=smem_floats(st, dr_width),
        SS_N=n, SS_NB=nb, SS_NG=len(st.slots), SS_NS=st.ns,
        SS_NS_A=max(1, st.ns), SS_CAP=st.cap, SS_CAP_A=max(1, st.cap),
        SS_M=lay.m, SS_MC=st.m_c, SS_MC_A=max(1, st.m_c),
        SS_NLIM=len(lay.limit_dofs), SS_NFRIC=len(lay.friction_dofs),
        SS_PGS_ITERS=int(cfg.pgs_iters), SS_ESC=_esc_layout(st)[1],
        SS_COMPACT=int(st.compact),
        SS_IMPLICIT=int(implicit),
        SS_DT=f(dt), SS_ERP_DT=f(cfg.erp / dt), SS_ALLOWANCE=f(cfg.allowance),
        SS_MAX_ERV=f(cfg.max_erv), SS_JERP_DT=f(cfg.joint_erp / dt),
        SS_CFM=f(cfg.cfm), SS_OMEGA=f(cfg.pgs_omega),
        SS_CONTACT_EPS=f(cfg.contact_eps),
    )
    out = [dynamics_header(model, dr_fields)]
    out += [f"#define {k} {v}\n" for k, v in defs.items()]
    sl = st.slots
    slot0 = np.cumsum([0] + [d["nslots"] for d in sl])[:-1]
    slot_geom = [g for g, d in enumerate(sl) for _ in range(d["nslots"])]
    col = lambda k: [d[k] for d in sl]
    out += [
        c_ints("c_g_type", col("gtype")), c_ints("c_g_body", col("body")),
        c_ints("c_g_slot0", slot0), c_ints("c_slot_geom", slot_geom),
        c_floats("c_g_rot", col("rot")), c_floats("c_g_pos", col("pos")),
        c_floats("c_g_size", col("size")), c_floats("c_g_n", col("n")),
        c_floats("c_g_off", col("off")), c_floats("c_g_t1", col("t1")),
        c_floats("c_g_t2", col("t2")), c_floats("c_g_fric", col("fric")),
        c_floats("c_g_rest", col("rest")),
        c_ints("c_lim_dof", lay.limit_dofs),
        c_floats("c_q_lower", h("q_lower")),
        c_floats("c_q_upper", h("q_upper")),
        c_floats("c_limited", h("limited")),
        c_ints("c_fric_dof", lay.friction_dofs),
        c_floats("c_dof_friction", h("dof_friction")),
        c_ints("c_findex", st.findex_c),
    ]
    if dr_fields:
        gf, wf = h("geom_friction"), h("wg_friction")
        gr, wr = h("geom_restitution"), h("wg_restitution")
        out += [
            c_ints("c_g_gi", col("gi")), c_ints("c_g_wi", col("wi")),
            c_floats("c_g_fric_g", [gf[d["gi"]] for d in sl]),
            c_floats("c_g_fric_w", [wf[d["wi"]] for d in sl]),
            c_floats("c_g_rest_g", [gr[d["gi"]] for d in sl]),
            c_floats("c_g_rest_w", [wr[d["wi"]] for d in sl]),
        ]
    return "".join(out)


class SubstepKernel:
    """The substep kernel built for one model digest and DR field set (a
    subset of DR_FIELDS_SUB, each leaf then a per-env input)."""

    def __init__(self, model: SkelModel, st: Optional[_SubStatic] = None,
                 dr_fields=()):
        bad = [f for f in dr_fields if f not in DR_FIELDS_SUB]
        if bad:
            raise ValueError(f"the substep kernel takes no per-env {bad}; "
                             f"its DR leaves are {DR_FIELDS_SUB}")
        self.model = model
        self.st = st or _SubStatic(model)
        self.dr_fields = tuple(dr_fields)
        self.dr_width = sum(w for _, _, w in dr_layout(model, dr_fields))
        self.shape = launch_shape(self.st, self.dr_width)
        self.sizes = _out_sizes(self.st)
        ends = np.cumsum([0] + [self.sizes[f] for f in _OUT_FIELDS])
        self._spans = {f: (int(ends[i]), int(ends[i + 1]))
                       for i, f in enumerate(_OUT_FIELDS)}
        self._width = int(ends[-1])
        self._header = model_header(model, self.st, self.dr_fields)
        self._build = None
        self._lib = None
        self._host_lib = None

    def start_build(self):
        if self._build is None:
            self._build = cuda_build.start_build(
                "dartenv_substep", "substep.cu", header_text=self._header,
                header_name="substep_model.h",
                deps=("substep_body.h", "dynamics_body.h", "pgs_row.h"))
        return self._build

    def _check_dims(self, lib):
        dims = (ctypes.c_int * 6)()
        lib.substep_dims(dims)
        want = [self.st.n, self.st.layout.m, self.st.ns, self.sizes["esc"],
                self.shape[0], self.dr_width]
        if list(dims) != want:
            raise RuntimeError(
                f"substep kernel built for sizes {list(dims)}, the model "
                f"needs {want}")

    def load(self):
        if self._lib is None:
            lib = cuda_build.finish_build(self.start_build())
            vp, ci = ctypes.c_void_p, ctypes.c_int
            lib.substep_launch.argtypes = [vp] * 13 + [ci, vp]
            lib.substep_launch.restype = ci
            self._check_dims(lib)
            self._lib = lib
        return self._lib

    def run_host(self, q, dq, tau, lam_prev, *dr_vals):
        """The kernel's per-env arithmetic (csrc/substep_body.h) built
        with the host C++ compiler and run as a loop over envs on float32
        CPU tensors.  For tests on machines without a GPU: nothing on the
        main path calls it, and it is not a stand-in for the kernel."""
        B = q.shape[0]
        if self._host_lib is None:
            lib = cuda_build.build_host(
                "dartenv_substep_host", "substep_host.cpp",
                header_text=self._header, header_name="substep_model.h",
                deps=("substep_body.h", "dynamics_body.h", "pgs_row.h"))
            lib.substep_host.argtypes = [ctypes.c_void_p] * 13 + [
                ctypes.c_int]
            lib.substep_host.restype = ctypes.c_int
            self._check_dims(lib)
            self._host_lib = lib
        ins = [x.to(torch.float32).contiguous()
               for x in (q, dq, tau, lam_prev)]
        if any(x.is_cuda for x in ins):
            raise ValueError("run_host takes CPU tensors")
        dr = dr_inputs(self.model, self.dr_fields,
                       [v.to(torch.float32) for v in dr_vals], B, "cpu",
                       "substep host build")
        outs = {f: torch.zeros((B, self.sizes[f]), dtype=torch.float32)
                for f in _OUT_FIELDS}
        self._host_lib.substep_host(
            *[x.data_ptr() for x in ins],
            *[outs[f].data_ptr() for f in _OUT_FIELDS], c_ptrs(dr), B)
        return outs

    def __call__(self, q, dq, tau, lam_prev, *dr_vals):
        """q, dq, tau: (B, n); lam_prev: (B, m); float32 CUDA tensors;
        dr_vals: the values of the DR leaves, (B, ...) float32 on the same
        device.  Returns the eight `_OUT_FIELDS` as (B, k) tensors."""
        global SUBSTEP_LAUNCHES
        st = self.st
        B = q.shape[0]
        want = {"q": (q, st.n), "dq": (dq, st.n), "tau": (tau, st.n),
                "lam_prev": (lam_prev, st.layout.m)}
        for name, (x, k) in want.items():
            if (not x.is_cuda or x.dtype != torch.float32
                    or x.shape != (B, k) or x.device != q.device):
                raise ValueError(
                    f"substep kernel: {name} must be a float32 CUDA tensor "
                    f"of shape {(B, k)}, got {x.dtype} {tuple(x.shape)} on "
                    f"{x.device}")
        dr = dr_inputs(self.model, self.dr_fields, dr_vals, B, q.device,
                       "substep kernel")
        lib = self.load()
        ins = [x.contiguous() for x in (q, dq, tau, lam_prev)]
        # one allocation; each output a contiguous (B, k) view of it
        buf = torch.empty((B * self._width,), dtype=torch.float32,
                          device=q.device)
        outs = {f: buf[B * a:B * b].view(B, b - a)
                for f, (a, b) in self._spans.items()}
        if B == 0:
            return outs
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream().cuda_stream
            code = lib.substep_launch(
                *[x.data_ptr() for x in ins],
                *[outs[f].data_ptr() for f in _OUT_FIELDS], c_ptrs(dr), B,
                stream)
        cuda_build.check_launch(code, "substep kernel")
        SUBSTEP_LAUNCHES += 1
        return outs


_KERNELS: Dict[str, SubstepKernel] = {}


def get_substep_kernel(model: SkelModel, st: Optional[_SubStatic] = None,
                       dr_fields=()) -> SubstepKernel:
    """The (cached) kernel object for this model's digest and DR fields."""
    k = SubstepKernel(model, st, dr_fields)
    return _KERNELS.setdefault(k._header, k)


# ---------------------------------------------------------------------------
# hybrid exact escalation over the substep's outputs
# ---------------------------------------------------------------------------

def gather_escalation(st: _SubStatic, cfg, outs):
    """Top-K by residual and ONE gather of the packed `esc` buffer; the
    boxed LCPs of the worst K envs, operator rebuilt from M and Jc with the
    port's own Cholesky.  Returns a dict (worst, idx, A, b, lo, hi, mu,
    act, lam_c, sel_slots, MinvJt).  Its sums run in the escalation
    kernel's order (math/linalg.seq_mm): it is the plain version of the
    kernel's rebuild."""
    n, m_c = st.n, st.m_c
    res = outs["res"][:, 0]
    B = res.shape[0]
    K = escalation_size(B, cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    blk = unpack_esc(st, outs["esc"][idx])
    actk = blk["act"]
    Mk = blk["M"].reshape(K, n, n)
    Jk = blk["Jc"].reshape(K, m_c, n)
    Jt = Jk.transpose(-1, -2)
    if n > _UNROLL_MAX:
        MinvJt = seq_mm(inv_psd(Mk, eps=1e-10, seq=True), Jt)
    else:
        MinvJt = chol_solve(chol(Mk, eps=1e-10), Jt)
    eye = torch.eye(m_c, dtype=actk.dtype, device=actk.device)
    Ak = seq_mm(Jk, MinvJt) + cfg.cfm * eye
    Ak = (Ak * actk[:, :, None] * actk[:, None, :]
          + eye * (1.0 - actk)[:, None, :])
    return dict(worst=worst, idx=idx, A=Ak, b=blk["b"], lo=blk["lo"],
                hi=blk["hi"], mu=blk["mu"], act=actk, lam_c=blk["lam_c"],
                sel_slots=blk["sel_slots"], MinvJt=MinvJt)


def escalate_reference(st: _SubStatic, cfg, outs, dq_plus, lam_full,
                       exact1, exact2=None):
    """The plain version of the escalation kernel's fused mode, as torch
    ops: top-K by residual, one gather of `esc`, operator rebuild, warm
    tier-1 (+ optional cold tier-2) exact re-solve by `exact1` / `exact2`,
    keep-best by residual, the refinement tier of cfg.escalate_ref64 /
    cfg.escalate_ref, and DELTA-form `index_add` patches of dq_plus
    and lam_full (envs outside the top K, and escalated envs whose
    re-solve is no better, keep their values bit for bit).  Returns new
    (dq_plus, lam_full), the top-K idx, take (K,) bool and the residual
    of the point kept (K,)."""
    ns, cap = st.ns, st.cap
    g = gather_escalation(st, cfg, outs)
    worst, idx, lamk = g["worst"], g["idx"], g["lam_c"]
    K = idx.shape[0]
    prob = (g["A"], g["b"], g["lo"], g["hi"], g["mu"], g["act"])
    lam_new, take, res_kept = keep_best(prob, st.findex_c, worst, lamk,
                                        cfg.escalate_tol, exact1, exact2,
                                        *st.ref_passes)
    dlam = torch.where(take[:, None], lam_new - lamk,
                       torch.zeros_like(lamk))
    dqp_delta = seq_mv(g["MinvJt"], dlam)
    slots = torch.arange(ns, dtype=dlam.dtype, device=dlam.device)
    Wk = (g["sel_slots"][:, :, None] == slots).to(dlam.dtype)
    dlam_con = dlam[:, : 3 * cap].reshape(K, cap, 3)
    scat = torch.sum(Wk[:, :, :, None] * dlam_con[:, :, None, :],
                     dim=1).reshape(K, 3 * ns)
    lamf_delta = torch.cat([scat, dlam[:, 3 * cap:]], dim=1)
    return (dq_plus.index_add(0, idx, dqp_delta),
            lam_full.index_add(0, idx, lamf_delta), idx, take, res_kept)


def escalate_fused(st: _SubStatic, cfg, outs, dq_plus, lam_full, budgets):
    """The escalation stage on a float32 CUDA batch: the top K of the
    residuals in torch (a selection across the whole batch), then ONE
    launch of the escalation kernel's fused mode, which reads its envs'
    `esc` rows, rebuilds their operators, re-solves with the tiers of
    `budgets` (hopper_bpp.tier_budgets), keeps the best and patches copies
    of dq_plus and lam_full.  Returns what `escalate_reference` returns."""
    res = outs["res"][:, 0]
    K = escalation_size(res.shape[0], cfg.escalate_frac, cfg.escalate_kmax)
    worst, idx = torch.topk(res, K)
    dqp, lamf, take, res_kept = hopper_bpp.bpp_fused(
        st.escalation_header, st.escalation_dims, outs["esc"], dq_plus,
        lam_full, idx, worst, st.findex_c, cfg.escalate_tol, budgets)
    return dqp, lamf, idx, take, res_kept


def escalation_tiers(st: _SubStatic, cfg):
    """(exact1, exact2) of the escalation's tiers for `cfg` (the solvers of
    hopper_bpp.tier_solvers, exact2 None without tier 2), or (None, None)
    when the model does not escalate."""
    if cfg.escalate_frac <= 0.0 or st.m_c == 0:
        return None, None
    return hopper_bpp.tier_solvers(st.findex_c, hopper_bpp.tier_budgets(
        cfg.escalate_iters, cfg.escalate_refine, cfg.escalate_iters2,
        *st.ref_passes))


def escalation_diag(outs, idx, take, res_kept):
    """The post-escalation residual envelope of the whole batch, the JAX
    package's `with_diag` record: dict(res_pre (B,): every env's substep
    residual, idx (K,): the escalated envs, envelope (B,): res_pre with the
    escalated envs' entries replaced by the residual of the point kept,
    which is their own residual where none was taken)."""
    res = outs["res"][:, 0]
    return dict(res_pre=res, idx=idx,
                envelope=res.index_copy(0, idx, torch.where(
                    take, res_kept, res[idx])))


def escalate_batch(st: _SubStatic, cfg, outs, dq_plus, lam_full,
                   exact1, exact2=None, with_diag: bool = False):
    """The hybrid exact-escalation stage over the substep's outputs.  A
    float32 CUDA batch runs `escalate_fused` with the tiers that `exact1` /
    `exact2` carry (solvers of hopper_bpp.tier_solvers; others raise) and
    the refinement passes of st.ref_passes; any other batch runs
    `escalate_reference` with `exact1` / `exact2`.  A cfg whose refinement
    tier is not the digest's (st.ref_passes) is refused.  The inputs are
    not modified.  Returns new (dq_plus, lam_full), and with `with_diag`
    a third value, `escalation_diag`'s record."""
    asked = hopper_bpp.ref_tiers(cfg.escalate_ref, cfg.escalate_ref64)
    if asked != st.ref_passes:
        raise ValueError(
            f"escalate_batch: refinement passes {asked} (escalate_ref, "
            f"escalate_ref64) asked, the digest is built for "
            f"{st.ref_passes}")
    if cuda_build.use_kernel(dq_plus):
        out = escalate_fused(st, cfg, outs, dq_plus, lam_full,
                             hopper_bpp.solver_budgets(
                                 exact1, exact2, *st.ref_passes))
    else:
        out = escalate_reference(st, cfg, outs, dq_plus, lam_full, exact1,
                                 exact2)
    if with_diag:
        return out[:2] + (escalation_diag(outs, *out[2:]),)
    return out[:2]


# ---------------------------------------------------------------------------
# the substep phase
# ---------------------------------------------------------------------------

def slot_contact_values(model: SkelModel, dr_fields, dr_vals, gi, wi, ref):
    """(friction, restitution) of every contact slot, (ns,) on the model's
    static values, or (B, ns) where a DR leaf of either side is per-env:
    min of the geom's and the world geom's friction, max of their
    restitution (what the kernel's rows and its plain version read).
    gi, wi: each slot's geom and world geom, index tensors on ref's
    device."""
    dr = dict(zip(dr_fields, dr_vals))
    leaf = lambda f: (dr[f] if f in dr else getattr(model, f)).to(
        device=ref.device, dtype=ref.dtype)
    fric = torch.minimum(leaf("geom_friction")[..., gi],
                         leaf("wg_friction")[..., wi])
    rest = torch.maximum(leaf("geom_restitution")[..., gi],
                         leaf("wg_restitution")[..., wi])
    return fric, rest


def make_substep_phase(model: SkelModel, dr_fields=(),
                       with_diag: bool = False):
    """sub(q, dq, lam_prev, tau, *dr_vals) -> (q_new, dq_plus, lam_full,
    Contacts) for a batch, or None when the model is outside the fused
    path's scope (the caller keeps the phase-wise path) or a DR field is
    outside DR_FIELDS_SUB.  With `with_diag` (ValueError for a model that
    does not escalate) escalate_batch's record is a fifth value.  `sub.st`
    is the phase's static data.

    dr_vals: the per-env values of the `dr_fields` leaves, (B, ...)
    tensors; `model` is then the base model, whose values of those leaves
    are ignored, and the Contacts carry per-env friction and restitution
    where those leaves are per-env.  A float32 CUDA batch runs the
    substep kernel + `escalate_batch` (the escalation kernel's fused mode,
    in the span `constraints`) + `hopper_integrate.integrate` (in the
    span `integrate`); a CPU or float64 batch runs the plain versions in
    the same sequence."""
    dr_fields = tuple(dr_fields)
    if not in_fused_scope(model):
        return None
    if model.solver.solver != "pgs":
        return None
    if any(f not in DR_FIELDS_SUB for f in dr_fields):
        return None
    hopper_integrate.prepare(model)
    st = _SubStatic(model)
    cfg = model.solver
    dt = st.dt
    ns = st.ns
    t = lambda x: torch.as_tensor(np.asarray(x, dtype=np.float64))
    rep = lambda k: [d[k] for d in st.slots for _ in range(d["nslots"])]
    slot_normal = t(rep("n")).reshape(ns, 3)
    slot_fric, slot_rest = t(rep("fric")), t(rep("rest"))
    per_env_contact = bool(set(dr_fields) & {
        "geom_friction", "wg_friction", "geom_restitution",
        "wg_restitution"})

    exact1, exact2 = escalation_tiers(st, cfg)
    if with_diag and exact1 is None:
        raise ValueError(f"{model.name}: no escalation to record")
    kernel: List[Optional[SubstepKernel]] = [None]
    slot_consts = {}      # (device, dtype) -> static per-slot contact data

    def consts(ref):
        key = (ref.device, ref.dtype)
        if key not in slot_consts:
            slot_consts[key] = tuple(
                x.to(device=ref.device, dtype=ref.dtype)
                for x in (slot_normal, slot_fric, slot_rest))
            # each slot's geom and world geom, for per-env contact values
            slot_consts[key] += tuple(
                torch.as_tensor(rep(k), device=ref.device)
                for k in ("gi", "wi"))
        return slot_consts[key]

    def sub(q, dq, lam_prev, tau, *dr_vals):
        global PLAIN_CALLS
        B = q.shape[0]
        if cuda_build.use_kernel(q):
            if kernel[0] is None:
                kernel[0] = get_substep_kernel(model, st, dr_fields)
            outs = kernel[0](q, dq, tau, lam_prev, *dr_vals)
        else:
            PLAIN_CALLS += 1
            outs = substep_reference(with_leaves(model, dr_fields, dr_vals),
                                     st, q, dq, tau, lam_prev)
        dq_plus, lam_full, diag = outs["dq_plus"], outs["lam_full"], ()
        if exact1 is not None:
            with span("constraints"):
                dq_plus, lam_full, *diag = escalate_batch(
                    st, cfg, outs, dq_plus, lam_full, exact1, exact2,
                    with_diag=with_diag)
        with span("integrate"):
            q_new = hopper_integrate.integrate(model, q, dq_plus, dt)
        normal, fric, rest, gi, wi = consts(q)
        if per_env_contact:
            fric, rest = slot_contact_values(model, dr_fields, dr_vals, gi,
                                             wi, q)
        contacts = Contacts(
            pos=outs["con_pos"].reshape(B, ns, 3),
            normal=normal.expand(B, ns, 3),
            depth=outs["con_depth"], active=outs["con_active"],
            friction=fric.expand(B, ns), restitution=rest.expand(B, ns),
            overflow=outs["overflow"][:, 0],
        )
        return (q_new, dq_plus, lam_full, contacts, *diag)

    sub.st = st
    return sub
