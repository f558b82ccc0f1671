"""Multi-skeleton worlds: block-diagonal composition into one SkelModel.

A world steps every one of its skeletons each substep.  Here that is ONE
composed model: a forest of skeletons is already first-class (roots have
parent -1, and every kinematic pass gathers per-body parents), so
composition is concatenation — bodies, dofs and geoms of each skeleton
appended with offset indices, the ancestor mask recomputed for the forest,
and cross-skeleton contact pairs added to `self_pairs` (the constraint
layer's signed slot masks take any body pair).  One sim step, one LCP per
env, full robot-object coupling.  `SkelModel.skel_ranges` records each
source skeleton's (body, dof) spans.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from dartenv_tpu_torch.model.skel_model import SkelModel, ancestor_mask_np


def _cat(vals):
    vals = [v for v in vals if v is not None]
    return torch.cat(vals) if vals else None


def _cat_or_zeros(models, field):
    """Concatenate a per-dof field, with zeros for a model that leaves it
    None (a plain _cat would drop the segment and shift the dofs)."""
    if all(getattr(m, field) is None for m in models):
        return None
    return torch.cat([m.q_init.new_zeros(m.n) if getattr(m, field) is None
                      else getattr(m, field) for m in models])


def _same_world(a: SkelModel, b: SkelModel) -> bool:
    def same(x, y):
        return x.shape == y.shape and bool(np.allclose(
            x.detach().cpu().numpy(), y.detach().cpu().numpy()))
    return same(a.wg_normal, b.wg_normal) and same(a.wg_offset, b.wg_offset)


def compose_models(models: Sequence[SkelModel], cross_collide: bool = True,
                   name: Optional[str] = None) -> SkelModel:
    """Compose skeletons into one block-diagonal SkelModel.

    cross_collide: add a contact pair for every (collidable geom of
    skeleton i) x (collidable geom of skeleton j), i < j.  Collidable =
    appears in the model's world_pairs when the world has geometry, else
    every geom.  Every convex type combination is supported
    (collision/support.py).  Identical world geometry collapses to the
    first model's; the composed model takes the first model's solver
    settings, dt and gravity."""
    models = list(models)
    assert models, "compose_models needs at least one skeleton"
    if len(models) == 1:
        return models[0]
    m0 = models[0]
    for m in models[1:]:
        assert m.dt == m0.dt, "skeletons must share the world timestep"

    body_off, dof_off, geom_off, mesh_off = [], [], [], []
    b = d = g = me = 0
    for m in models:
        body_off.append(b)
        dof_off.append(d)
        geom_off.append(g)
        mesh_off.append(me)
        b += m.nb
        d += m.n
        g += m.ng
        me += 0 if m.mesh_verts is None else int(m.mesh_verts.shape[0])
    nb, n = b, d

    parent = tuple(p + (body_off[i] if p >= 0 else 0)
                   for i, m in enumerate(models) for p in m.parent)
    q_start = tuple(qs + dof_off[i]
                    for i, m in enumerate(models) for qs in m.q_start)
    ndof = tuple(nd for m in models for nd in m.ndof)
    joint_type = tuple(t for m in models for t in m.joint_type)

    if all(_same_world(m, m0) for m in models[1:]):
        wg = [m0.wg_normal, m0.wg_offset, m0.wg_friction, m0.wg_restitution]
        w_off = [0] * len(models)
    else:
        wg = [_cat([getattr(m, f) for m in models])
              for f in ("wg_normal", "wg_offset", "wg_friction",
                        "wg_restitution")]
        w_off, w = [], 0
        for m in models:
            w_off.append(w)
            w += int(m.wg_offset.shape[0])

    world_pairs = tuple((gi + geom_off[i], wi + w_off[i])
                        for i, m in enumerate(models)
                        for gi, wi in m.world_pairs)
    self_pairs = [(ga + geom_off[i], gb + geom_off[i])
                  for i, m in enumerate(models) for ga, gb in m.self_pairs]
    if cross_collide:
        collidable = []
        for i, m in enumerate(models):
            gs = (sorted({gi for gi, _ in m.world_pairs}) if m.world_pairs
                  else list(range(m.ng)))
            collidable.append([gi + geom_off[i] for gi in gs])
        for i in range(len(models)):
            for j in range(i + 1, len(models)):
                self_pairs += [(ga, gb) for ga in collidable[i]
                               for gb in collidable[j]]

    # mesh store: re-pad to the common Vmax (the first vertex repeated)
    meshes = [(m.mesh_verts[k], m.mesh_vmask[k]) for m in models
              if m.mesh_verts is not None
              for k in range(int(m.mesh_verts.shape[0]))]
    mesh_verts = mesh_vmask = None
    if meshes:
        vmax = max(int(v.shape[0]) for v, _ in meshes)
        mesh_verts = torch.stack([
            torch.cat([v, v[:1].expand(vmax - v.shape[0], 3)]) for v, _ in
            meshes])
        mesh_vmask = torch.stack([
            torch.cat([k, k.new_zeros(vmax - k.shape[0])]) for _, k in
            meshes])
    geom_mesh = tuple((gm + mesh_off[i] if gm >= 0 else -1)
                      for i, m in enumerate(models) for gm in m.geom_mesh)

    cat = lambda f: _cat([getattr(m, f) for m in models])
    return SkelModel(
        nb=nb, n=n, parent=parent, joint_type=joint_type, q_start=q_start,
        ndof=ndof,
        body_names=tuple(nm for m in models for nm in m.body_names),
        joint_names=tuple(nm for m in models for nm in m.joint_names),
        world_pairs=world_pairs, self_pairs=tuple(self_pairs), dt=m0.dt,
        name=name or "+".join(m.name for m in models), solver=m0.solver,
        geom_body=tuple(gb + body_off[i] for i, m in enumerate(models)
                        for gb in m.geom_body),
        geom_type=tuple(t for m in models for t in m.geom_type),
        geom_mesh=geom_mesh,
        skel_ranges=tuple((m.name, body_off[i], m.nb, dof_off[i], m.n)
                          for i, m in enumerate(models)),
        pj_rot=cat("pj_rot"), pj_pos=cat("pj_pos"), cj_rot=cat("cj_rot"),
        cj_pos=cat("cj_pos"), axes=cat("axes"), mass=cat("mass"),
        com=cat("com"), inertia=cat("inertia"),
        damping=_cat_or_zeros(models, "damping"),
        spring_stiff=_cat_or_zeros(models, "spring_stiff"),
        rest_pos=_cat_or_zeros(models, "rest_pos"),
        dof_friction=_cat_or_zeros(models, "dof_friction"),
        servo_flimit=_cat_or_zeros(models, "servo_flimit"),
        q_lower=cat("q_lower"), q_upper=cat("q_upper"),
        limited=cat("limited"), q_init=cat("q_init"), dq_init=cat("dq_init"),
        ancestor_mask=torch.as_tensor(
            ancestor_mask_np(parent, q_start, ndof, n),
            dtype=m0.dtype, device=m0.device),
        geom_size=cat("geom_size"), geom_rot=cat("geom_rot"),
        geom_pos=cat("geom_pos"), geom_friction=cat("geom_friction"),
        geom_restitution=cat("geom_restitution"),
        mesh_verts=mesh_verts, mesh_vmask=mesh_vmask,
        wg_normal=wg[0], wg_offset=wg[1], wg_friction=wg[2],
        wg_restitution=wg[3], gravity=m0.gravity,
    )
