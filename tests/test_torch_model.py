"""PyTorch port, model layer: numpy round trip and the port's own .skel
parser against the JAX parser (same leaves, exact ints, floats <= 1e-12 in
float64)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dartenv_tpu.model import skel_parser as jparser
from dartenv_tpu_torch.model import skel_parser as tparser
from dartenv_tpu_torch.model.skel_model import FLOAT_LEAVES, STATIC_FIELDS
from torch_port_util import flatten_jax_model, port_model

ASSETS = ["walker2d.skel", "hopper_capsule.skel", "cartpole.skel",
          "doublependulum.skel"]


@pytest.mark.parametrize("asset", ASSETS)
def test_model_from_numpy_round_trip(asset):
    jm = jparser.parse_skel(jparser.asset_path(asset),
                            dtype=jnp.float64).robot
    static, arrays = flatten_jax_model(jm)
    tm = port_model(jm)
    for f in FLOAT_LEAVES:
        leaf = getattr(tm, f)
        assert leaf.dtype == torch.float64 and leaf.device.type == "cpu"
        np.testing.assert_array_equal(leaf.numpy(), arrays[f])
    for f in ("nb", "n", "parent", "joint_type", "q_start", "ndof",
              "world_pairs", "self_pairs", "dt"):
        assert getattr(tm, f) == static[f], f
    assert tm.geom_body == tuple(int(v) for v in arrays["geom_body"])
    assert tm.geom_type == tuple(int(v) for v in arrays["geom_type"])
    assert dataclasses.asdict(tm.solver) == {
        k: getattr(jm.solver, k) for k in dataclasses.asdict(tm.solver)}
    # .to() moves every leaf
    t32 = tm.to(dtype=torch.float32)
    assert all(getattr(t32, f).dtype == torch.float32 for f in FLOAT_LEAVES)


@pytest.mark.parametrize("asset", ASSETS)
def test_port_parser_matches_jax_parser(asset):
    jm = jparser.parse_skel(jparser.asset_path(asset),
                            dtype=jnp.float64).robot
    ref = port_model(jm)
    got = tparser.parse_skel(tparser.asset_path(asset), dtype=torch.float64,
                             device="cpu").robot
    for f in STATIC_FIELDS:
        assert getattr(got, f) == getattr(ref, f), f
    for f in FLOAT_LEAVES:
        a, b = getattr(got, f), getattr(ref, f)
        assert a.shape == b.shape, f
        assert float((a - b).abs().max()) <= 1e-12 if a.numel() else True, f
