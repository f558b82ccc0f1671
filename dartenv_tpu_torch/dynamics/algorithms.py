"""Per-body reference algorithms.  Only the pose-only forward kinematics
that the task layer (obs / reward / done) calls is ported so far."""
from __future__ import annotations

import torch

from dartenv_tpu_torch.dynamics.joints import JOINT_FNS
from dartenv_tpu_torch.math import spatial as sp
from dartenv_tpu_torch.model.skel_model import SkelModel


def fk_positions(model: SkelModel, q):
    """Pose-only forward kinematics of a batch: q (B, n) ->
    (R_w (B, nb, 3, 3), p_w (B, nb, 3))."""
    R_w, p_w = [], []
    for i in range(model.nb):
        a, b = model.q_start[i], model.q_start[i] + model.ndof[i]
        Rj, pj = JOINT_FNS[model.joint_type[i]](model.axes[i], q[:, a:b])
        # T_rel = T_pj o T_joint o inv(T_cj)
        R1 = sp.mm(model.pj_rot[i], Rj)
        p1 = model.pj_pos[i] + sp.mv(model.pj_rot[i], pj)
        cj_inv_R = model.cj_rot[i].transpose(-1, -2)
        cj_inv_p = -sp.mv(cj_inv_R, model.cj_pos[i])
        R_rel = sp.mm(R1, cj_inv_R)
        p_rel = p1 + sp.mv(R1, cj_inv_p)
        par = model.parent[i]
        if par < 0:
            R_w.append(R_rel)
            p_w.append(p_rel)
        else:
            R_w.append(sp.mm(R_w[par], R_rel))
            p_w.append(p_w[par] + sp.mv(R_w[par], p_rel))
    return torch.stack(R_w, dim=1), torch.stack(p_w, dim=1)
