"""Domain randomization: per-env values of a model's physics leaves.

A randomized batch is the base model with some numeric leaves replaced by
tensors with a leading env axis (B, ...); the other leaves stay shared.
`randomize_model` draws such a batch; `make_randomized_sim_step` steps it:

  * a model inside the fused path's scope, with fields within
    engine/hopper_substep.DR_FIELDS_SUB, runs engine/world.
    make_dr_sim_step: on a float32 CUDA batch the substep kernel with the
    DR leaves as per-env inputs, then the escalation kernel's fused mode;
  * any other model or field set runs the phase-wise step (engine/world.
    phasewise_substep) with the per-env model.  Its dynamics phase is the
    dynamics kernel with the DR_FIELDS_DYN leaves as per-env inputs,
    unless a field is a frame leaf (FRAME_LEAVES: the kernel bakes the
    base model's frames into its build), which runs the plain batched
    dynamics on the per-env model; collision reads the per-env geom and
    ground leaves, the constraint solve the per-env joint limits.

Every numeric leaf may be randomized except those that define the static
constraint / contact layout (LAYOUT_LEAVES), which are read when a step is
built.  q_init and dq_init are accepted and enter no sim step.
"""
from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch

from dartenv_tpu_torch.dynamics.hopper_dynamics import (
    DR_FIELDS_DYN, make_dynamics_phase,
)
from dartenv_tpu_torch.engine.constraints import build_layout
from dartenv_tpu_torch.engine.world import (
    _advance, make_dr_sim_step, phasewise_substep,
)
from dartenv_tpu_torch.model.skel_model import FLOAT_LEAVES, SkelModel

# leaves whose values feed the static layout: never batch these
LAYOUT_LEAVES = frozenset({
    "limited", "dof_friction", "servo_flimit", "geom_body", "geom_type",
    "ancestor_mask",
})

# the joint frames and axes, which the dynamics kernel reads from its
# build: a field set with one of them runs the plain batched dynamics
FRAME_LEAVES = frozenset({"pj_rot", "pj_pos", "cj_rot", "cj_pos", "axes"})

# steps of the phase-wise route whose dynamics ran the plain per-env
# version (a model the dynamics kernel can not serve, or a frame leaf);
# chosen when the step is built, counted when it runs
PLAIN_DYNAMICS_STEPS = 0


def check_fields(fields: Sequence[str]) -> tuple:
    """The randomized fields as a tuple, after the check of the JAX
    package's model_in_axes: ValueError for a layout leaf (or a name that
    is not a numeric leaf)."""
    fields = tuple(fields)
    bad = set(fields) & LAYOUT_LEAVES
    if bad:
        raise ValueError(
            f"cannot batch layout-defining leaves {sorted(bad)}; they are "
            "read when the step is built, to make the static constraint "
            "layout")
    unknown = [f for f in fields if f not in FLOAT_LEAVES]
    if unknown:
        raise ValueError(f"{unknown} are not numeric model leaves")
    return fields


def randomize_model(model: SkelModel, spec: Dict[str, float],
                    num_envs: int, generator: torch.Generator) -> SkelModel:
    """Batched copy of `model`: each field in `spec` gets a leading env
    axis, its values scaled per env by uniform(1 - s, 1 + s) (s =
    spec[field]) drawn from `generator` (on the generator's device, then
    moved to the model's).  As in the JAX package, a rotation leaf is
    scaled like any other and not renormalized."""
    kw = {}
    for f, s in spec.items():
        if f in LAYOUT_LEAVES:
            raise ValueError(f"cannot randomize layout leaf {f!r}")
        leaf = getattr(model, f)
        u = torch.rand((num_envs,) + (1,) * leaf.ndim, generator=generator,
                       device=generator.device, dtype=torch.float64)
        scale = (1.0 - s) + (2.0 * s) * u
        kw[f] = leaf[None] * scale.to(device=leaf.device, dtype=leaf.dtype)
    return model.replace(**kw)


def make_randomized_sim_step(model: SkelModel, fields: Sequence[str],
                             force_phasewise: bool = False) -> Callable:
    """stepper(bmodel, state, tau) -> (state', Contacts): one substep of a
    batch whose `fields` carry per-env values in `bmodel` (as
    randomize_model returns it; its other leaves are taken from `model`).
    force_phasewise skips the fused route (the ablation of the
    throughput bench)."""
    fields = check_fields(fields)
    kstep = None if force_phasewise else make_dr_sim_step(model, fields)
    if kstep is not None:
        def stepper(bmodel, state, tau):
            return kstep(state, tau, tuple(getattr(bmodel, f)
                                           for f in fields))
        return stepper

    # The phase-wise step with the per-env model.  Its dynamics phase is
    # the dynamics kernel with the DR_FIELDS_DYN leaves passed explicitly:
    # the route the JAX package's make_dynamics_phase prescribes for DR
    # callers (its own fallback can not take it only because it runs the
    # model traced under vmap).  A frame leaf keeps the kernel out: it
    # would step with the base model's frames.  The geom, ground and limit
    # leaves go to collision and the constraint solve, which read the
    # per-env model.
    layout = build_layout(model)
    dyn_fields = tuple(f for f in fields if f in DR_FIELDS_DYN)
    dyn_phase = (None if FRAME_LEAVES & set(fields)
                 else make_dynamics_phase(model, dyn_fields))

    def stepper(bmodel, state, tau):
        global PLAIN_DYNAMICS_STEPS
        m = model.replace(**{f: getattr(bmodel, f) for f in fields})
        if dyn_phase is not None:
            vals = tuple(getattr(bmodel, f) for f in dyn_fields)
            dyn = lambda q, dq, t: dyn_phase(q, dq, t, *vals)
        else:
            PLAIN_DYNAMICS_STEPS += 1
            dyn = None
        return _advance(state, model.dt,
                        *phasewise_substep(m, layout, state, tau, dyn))

    return stepper
