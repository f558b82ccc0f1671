"""The one generator of every traffic mix: the inputs of each control step
drawn from the run's seed, in a fixed order, on the device.

    gen = Inputs(config, traffic, seed, device)
    actions, reset_noise, perturb_noise = gen.step()

actions: (B, a) uniform in the task's control bounds (the random policy);
reset_noise: (2, B, n) uniform(-s, s), s the configuration's reset noise,
for the auto-reset of the envs that finish; perturb_noise: with pushes,
the dice of each substep and env, (u (S, B) uniform in [0, 1), axis (S, B)
in {0, 1}, sign (S, B) in {-1, +1}), S = frame_skip, else None.  The same
seed gives the same numbers; they are handed to the program and to the
reference alike.  `sample_steps` draws which control steps of the window
the output check keeps.
"""
import random

import numpy as np
import torch


def torch_seed(seed):
    """A torch.Generator seed from any whole number."""
    return int(seed) % (2 ** 63)


class Inputs:
    def __init__(self, config, traffic, seed, device, dtype=torch.float32):
        bounds = np.asarray(config["control_bounds"], dtype=np.float64)
        self.hi = torch.as_tensor(bounds[0], dtype=dtype, device=device)
        self.lo = torch.as_tensor(bounds[1], dtype=dtype, device=device)
        self.B = int(traffic["batch"])
        self.n = int(config["sizes"]["n"])
        self.s = float(config["reset_noise"])
        self.S = int(config["frame_skip"])
        self.pushes = traffic.get("pushes") is not None
        self.device, self.dtype = device, dtype
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(torch_seed(seed))

    def actions(self):
        u = torch.rand((self.B, self.hi.shape[0]), generator=self.gen,
                       device=self.device, dtype=self.dtype)
        return u * (self.hi - self.lo) + self.lo

    def reset_noise(self):
        u = torch.rand((2, self.B, self.n), generator=self.gen,
                       device=self.device, dtype=self.dtype)
        return (2.0 * u - 1.0) * self.s

    def perturb_noise(self):
        if not self.pushes:
            return None
        shape, g, d = (self.S, self.B), self.gen, self.device
        u = torch.rand(shape, generator=g, device=d, dtype=self.dtype)
        axis = torch.randint(0, 2, shape, generator=g, device=d)
        sign = torch.randint(0, 2, shape, generator=g,
                             device=d).to(self.dtype) * 2 - 1
        return u, axis, sign

    def step(self):
        return self.actions(), self.reset_noise(), self.perturb_noise()


def sample_steps(traffic, seed, dense=False):
    """The control steps of the window whose outputs are checked: the
    first within the first `check_gap` steps, each next 1 to
    2 * check_gap - 1 steps later, `check_samples` in all (a window that
    ends sooner checks fewer); `dense`: the first `check_samples` steps
    (the control, whose steps are slow)."""
    if dense:
        return list(range(int(traffic["check_samples"])))
    rng = random.Random(int(seed) * 7919 + 17)
    gap = int(traffic["check_gap"])
    out, at = [], rng.randrange(gap)
    for _ in range(int(traffic["check_samples"])):
        out.append(at)
        at += rng.randrange(1, 2 * gap)
    return out


def gym_actions(config, seed):
    """The gym cell's actions: a numpy Generator seeded by the run's seed,
    uniform in the control bounds, one (a,) float64 array per call."""
    bounds = np.asarray(config["control_bounds"], dtype=np.float64)
    rng = np.random.default_rng(int(seed))

    def draw():
        return rng.uniform(bounds[1], bounds[0])

    return draw
