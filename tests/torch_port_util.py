"""Shared helpers of the tests/test_torch_*.py files: carry a JAX SkelModel
across to the PyTorch port as numpy, so both packages compute on the same
numbers (the port itself never imports the JAX package)."""
import dataclasses

import numpy as np
import torch

from dartenv_tpu_torch.model.convert import model_from_numpy
from dartenv_tpu_torch.model.skel_model import STATIC_FIELDS


# The suite runs several worker processes on one machine, each also
# hosting JAX's own thread pools: keep PyTorch to one thread per worker
# (the tensors here are tiny; more threads only oversubscribe the cores).
torch.set_num_threads(1)


def flatten_jax_model(model):
    """(static dict, arrays dict) of a JAX SkelModel via dataclasses.fields
    + np.asarray."""
    static, arrays = {}, {}
    for f in dataclasses.fields(model):
        v = getattr(model, f.name)
        if f.name in STATIC_FIELDS and f.name not in ("geom_body",
                                                      "geom_type"):
            static[f.name] = v
        elif v is not None and not isinstance(v, tuple):
            arrays[f.name] = np.asarray(v)
    return static, arrays


def port_model(model, dtype=torch.float64, device="cpu"):
    static, arrays = flatten_jax_model(model)
    return model_from_numpy(static, arrays, device=device, dtype=dtype)


def T(x, dtype=torch.float64):
    return torch.as_tensor(np.array(x), dtype=dtype)


def N(x):
    return np.asarray(x.detach().cpu().numpy() if torch.is_tensor(x) else x,
                      dtype=np.float64)


def rel_err(got, ref):
    got, ref = N(got).reshape(-1), N(ref).reshape(-1)
    return np.abs(got - ref).max() / max(1.0, np.abs(ref).max())


def dr_leaves(model, fields, B, seed):
    """Per-env values of the DR leaves `fields` of a JAX SkelModel, drawn
    with numpy from `seed`: each leaf scaled entry by entry by
    uniform(0.7, 1.3), the inertia tensors by one such factor per body
    (so they stay positive definite), spring stiffness uniform(0, 20) and
    rest positions uniform(-0.1, 0.1) (zero in the shipped models).
    Returns {field: (B, ...) float64 array}."""
    rng = np.random.default_rng(seed)
    out = {}
    for f in fields:
        base = np.asarray(getattr(model, f), np.float64)
        shape = (B,) + base.shape
        if f == "inertia":
            v = base[None] * rng.uniform(0.7, 1.3, shape[:2] + (1, 1))
        elif f == "spring_stiff":
            v = rng.uniform(0.0, 20.0, shape)
        elif f == "rest_pos":
            v = rng.uniform(-0.1, 0.1, shape)
        else:
            v = base[None] * rng.uniform(0.7, 1.3, shape)
        out[f] = v
    return out


def port_dr_model(model, leaves, dtype=torch.float64, device="cpu"):
    """(JAX batched model, port base model, port batched model) of a JAX
    SkelModel and per-env values of some of its leaves ({field: (B, ...)
    array}): the batched models are the base with those leaves replaced,
    carried across by the same path as port_model (a leaf with a leading
    env axis becomes a (B, ...) tensor)."""
    import jax.numpy as jnp

    jb = model.replace(**{f: jnp.asarray(v) for f, v in leaves.items()})
    return (jb, port_model(model, dtype=dtype, device=device),
            port_model(jb, dtype=dtype, device=device))
