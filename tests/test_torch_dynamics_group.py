"""PyTorch port, the dynamics kernel's lane-group body (csrc/dynamics_body.h
dyn_group, csrc/dynamics.cu) without a GPU:

* its host build (csrc/dynamics_host.cpp, one lane that takes every item
  in order) equals, to the bit, the outputs the host build of the earlier
  one-thread-per-env body gave on the same inputs, recorded before the
  redesign in tests/data/dynamics_host_golden.npz (cartpole, walker2d and
  the two ModelBuilder chains with the six joint types the substep kernel
  lacks; do not re-record it);
* the packed output buffer keeps the wrapper's contract: five float32
  tensors of the shapes of dynamics_reference, each contiguous with the
  strides of a fresh tensor;
* the generated header's lane group and tree levels.
"""
import os
import shutil

import numpy as np
import pytest
import torch

from dartenv_tpu_torch.dynamics import hopper_dynamics as hd
from test_torch_dynamics_kernel import _OUTS, _torch_models

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "dynamics_host_golden.npz")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None,
                               reason="no host C++ compiler")


@pytest.fixture(scope="module")
def models():
    return _torch_models()


@needs_gxx
@pytest.mark.parametrize("name", ["cartpole", "walker2d", "chain_a",
                                  "chain_b"])
def test_host_build_equals_the_recorded_outputs(name, models):
    gold = np.load(GOLDEN)
    ins = [torch.as_tensor(gold[f"{name}/in/{k}"])
           for k in ("q", "dq", "tau")]
    got = hd.get_dynamics_kernel(models[name]).run_host(*ins)
    for k, x in zip(_OUTS, got):
        rec = torch.as_tensor(gold[f"{name}/out/{k}"])
        assert torch.equal(x, rec), (name, k)


@needs_gxx
def test_packed_outputs_keep_the_contract(models):
    model = models["walker2d"]
    B = 5
    q = model.q_init.to(torch.float32).expand(B, -1).clone()
    kern = hd.get_dynamics_kernel(model)
    got = kern.run_host(q, torch.zeros_like(q), torch.ones_like(q))
    ref = hd.dynamics_reference(model, q, torch.zeros_like(q),
                                torch.ones_like(q))
    assert len(got) == len(ref) == 5
    base = got[0].untyped_storage().data_ptr()
    for k, a, r in zip(_OUTS, got, ref):
        assert a.shape == r.shape == kern.shapes(B)[k], k
        assert a.dtype == torch.float32 and a.device.type == "cpu", k
        assert a.is_contiguous(), k
        assert a.stride() == torch.empty(a.shape).stride(), k
        # one allocation: every output is a view of the same buffer
        assert a.untyped_storage().data_ptr() == base, k
    assert torch.isfinite(got[0]).all()


def test_header_lane_group_and_levels(models):
    want = {"cartpole": 2, "doublependulum": 4, "walker2d": 16,
            "chain_a": 16, "chain_b": 8, "chain_weld": 4}
    for name, g in want.items():
        model = models[name]
        assert hd.lane_group(model) == g, name
        head = hd.dynamics_header(model)
        assert f"#define DY_G {g}\n" in head, name
        n = model.n
        assert f"#define DY_NPAIR {n * (n + 1) // 2}\n" in head, name
    walker = models["walker2d"]
    assert hd.depth_levels(walker.parent) == [[0], [1, 4], [2, 5], [3, 6]]
    anc = walker.host("ancestor_mask") > 0.5
    assert f"#define DY_NF {int(anc.sum())}\n" in hd.dynamics_header(walker)
