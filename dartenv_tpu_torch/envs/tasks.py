"""The batched tasks by name (make_task("walker2d", device="cpu"))."""
import importlib

import torch

_TASKS = {
    "cartpole": ("dartenv_tpu_torch.envs.cart_pole", "make_cartpole_task"),
    "hopper": ("dartenv_tpu_torch.envs.hopper", "make_hopper_task"),
    "walker2d": ("dartenv_tpu_torch.envs.walker2d", "make_walker2d_task"),
    "doublependulum": ("dartenv_tpu_torch.envs.double_pendulum",
                       "make_double_pendulum_task"),
    "reacher": ("dartenv_tpu_torch.envs.reacher", "make_reacher_task"),
    "walker3d": ("dartenv_tpu_torch.envs.walker3d", "make_walker3d_task"),
    "humanwalker": ("dartenv_tpu_torch.envs.human_walker",
                    "make_humanwalker_task"),
    "reacher2d": ("dartenv_tpu_torch.envs.reacher2d", "make_reacher2d_task"),
    "snake7link": ("dartenv_tpu_torch.envs.snake_7link",
                   "make_snake7link_task"),
    "dog": ("dartenv_tpu_torch.envs.dog", "make_dog_task"),
}


def make_task(name: str, dtype=torch.float32, device="cuda",
              lcp_solver=None, **solver_kw):
    """The named task on `device`; `lcp_solver` ("pgs" or "dantzig", None:
    the task's own) picks the contact solver and `solver_kw` overrides
    SolverConfig fields, as the task factories take them."""
    mod, fn = _TASKS[name]
    return getattr(importlib.import_module(mod), fn)(
        dtype=dtype, device=device, lcp_solver=lcp_solver, **solver_kw)
