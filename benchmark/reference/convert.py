"""Carry models and states across as numpy: the one place where data made
elsewhere (the port's own parser, or another implementation's model
flattened to numpy) becomes the port's tensors.

`model_from_numpy(static, arrays, device, dtype)` takes a dict of static
fields and a dict of numpy arrays keyed by SkelModel field name; the
caller decides where the numbers come from, so two implementations can be
held against each other on identical values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import numpy as np
import torch

from benchmark.reference.skel_model import (
    FLOAT_LEAVES, MESH_LEAVES, STATIC_FIELDS, SkelModel, SolverConfig,
)


def _tuple_of_ints(x):
    return tuple(int(v) for v in np.asarray(x).reshape(-1))


def _pairs(x):
    return tuple((int(a), int(b)) for a, b in x)


def solver_from_attrs(cfg: Any) -> SolverConfig:
    """SolverConfig from any object with the same attribute names
    (attributes the port does not know are ignored)."""
    if isinstance(cfg, SolverConfig):
        return cfg
    names = [f.name for f in dataclasses.fields(SolverConfig)]
    return SolverConfig(**{k: getattr(cfg, k) for k in names
                           if hasattr(cfg, k)})


def model_from_numpy(static: Dict[str, Any], arrays: Dict[str, np.ndarray],
                     device="cuda", dtype=torch.float32) -> SkelModel:
    """Build a SkelModel from static fields + numpy leaves.

    static: nb, n, parent, joint_type, q_start, ndof, body_names,
    joint_names, world_pairs, self_pairs, dt, name, solver (a SolverConfig
    or an object with its attribute names), and optionally skel_ranges.
    `geom_body` / `geom_type` / `geom_mesh` may sit in either dict (integer
    arrays become static tuples; a missing geom_mesh means no mesh geoms).
    arrays: every FLOAT_LEAVES entry, and the MESH_LEAVES where the model
    has mesh geoms (None / missing stays None).
    """
    kw: Dict[str, Any] = {}
    for f in STATIC_FIELDS:
        src = static if f in static else arrays
        if f not in src:
            continue
        v = src[f]
        if f in ("parent", "joint_type", "q_start", "ndof", "geom_body",
                 "geom_type", "geom_mesh"):
            v = _tuple_of_ints(v)
        elif f in ("world_pairs", "self_pairs"):
            v = _pairs(v)
        elif f in ("body_names", "joint_names"):
            v = tuple(str(s) for s in v)
        elif f in ("nb", "n"):
            v = int(v)
        elif f == "dt":
            v = float(v)
        elif f == "solver":
            v = solver_from_attrs(v)
        elif f == "skel_ranges":
            v = tuple((str(r[0]),) + tuple(int(x) for x in r[1:]) for r in v)
        kw[f] = v
    if "geom_mesh" not in kw and "geom_type" in kw:
        kw["geom_mesh"] = (-1,) * len(kw["geom_type"])
    for f in FLOAT_LEAVES + MESH_LEAVES:
        v = arrays.get(f)
        if v is None:
            continue
        kw[f] = torch.as_tensor(np.array(v, dtype=np.float64)).to(
            device=device, dtype=dtype)
    return SkelModel(**kw)
