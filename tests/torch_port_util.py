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
