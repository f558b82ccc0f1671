"""dartenv_tpu_torch: the PyTorch / CUDA port of the dartenv_tpu engine.

Sub-packages keep the names of the JAX package (`model`, `math`,
`dynamics`, `collision`, `lcp`, `engine`, `envs`, `parallel`, `bench`,
`api`, `utils`, `validation`) so a reader finds each counterpart.  Inside, PyTorch's idiom: plain functions on
tensors with the env batch written out as the LEADING axis, Python loops
where the JAX package scans, frozen dataclasses of tensors for state, and
an explicit `device` argument on every entry point (default "cuda"; no
entry point picks the CPU because it found no GPU).

The four kernels (the fused substep, the dynamics phase, PGS and the
block-pivoting exact solve) are hand-written CUDA C++ under `csrc/`, built
with nvcc for sm_90a at first use (`cuda_build.py`).

The gym surface is the JAX package's:
    import dartenv_tpu_torch as gym
    env = gym.make('DartHopper-v1')                 # on the GPU
    env = gym.make('DartHopper-v1', device="cpu")   # on the CPU
    obs = env.reset(); obs, r, done, info = env.step(env.action_space.sample())

Full-f32 products are asserted at import — the counterpart of the JAX
package's `jax.default_matmul_precision("highest")` guard: TF32 keeps ~3
decimal digits, enough to cost the mass matrix its positive-definiteness.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

from dartenv_tpu_torch.api import error, spaces  # noqa: F401
from dartenv_tpu_torch.api.core import (  # noqa: F401
    ActionWrapper, Env, ObservationWrapper, RewardWrapper, Wrapper,
)
from dartenv_tpu_torch.api.registration import (  # noqa: F401
    make, register, registry, spec,
)
from dartenv_tpu_torch.api import seeding  # noqa: F401
from dartenv_tpu_torch.api.benchmarks import (  # noqa: F401
    benchmark_spec, register_benchmark,
)
from dartenv_tpu_torch.api.wrappers import Monitor, TimeLimit  # noqa: F401
from dartenv_tpu_torch.api.configuration import (  # noqa: F401
    logger_setup, undo_logger_setup,
)
from dartenv_tpu_torch.api import scoreboard  # noqa: F401

__version__ = "0.1.0"


# ---------------------------------------------------------------------------
# Env registrations: the ids, max_episode_steps and reward_threshold of the
# reference's dart block of `gym/envs/__init__.py`
# ---------------------------------------------------------------------------

register(
    id="DartCartPole-v1",
    entry_point="dartenv_tpu_torch.envs.cart_pole:DartCartPoleEnv",
    max_episode_steps=1000,
    reward_threshold=950.0,
)

register(
    id="DartCartPoleSwingUp-v1",
    entry_point="dartenv_tpu_torch.envs.cart_pole:DartCartPoleSwingUpEnv",
    max_episode_steps=500,
)

register(
    id="DartReacher-v1",
    entry_point="dartenv_tpu_torch.envs.reacher:DartReacherEnv",
    max_episode_steps=500,
    reward_threshold=-3.75,
)

register(
    id="DartHopper-v1",
    entry_point="dartenv_tpu_torch.envs.hopper:DartHopperEnv",
    max_episode_steps=1000,
    reward_threshold=3800.0,
)

register(
    id="DartWalker2d-v1",
    entry_point="dartenv_tpu_torch.envs.walker2d:DartWalker2dEnv",
    max_episode_steps=1000,
    reward_threshold=None,
)

register(
    id="DartHumanWalker-v1",
    entry_point="dartenv_tpu_torch.envs.human_walker:DartHumanWalkerEnv",
    max_episode_steps=300,
)

register(
    id="DartDoubleInvertedPendulum-v1",
    entry_point="dartenv_tpu_torch.envs.double_pendulum:"
                "DartDoubleInvertedPendulumEnv",
    max_episode_steps=1000,
    reward_threshold=9100.0,
)

register(
    id="DartReacher2d-v1",
    entry_point="dartenv_tpu_torch.envs.reacher2d:DartReacher2dEnv",
    max_episode_steps=500,
)

register(
    id="DartSnake7Link-v1",
    entry_point="dartenv_tpu_torch.envs.snake_7link:DartSnake7LinkEnv",
    max_episode_steps=1000,
)

register(
    id="DartWalker3d-v1",
    entry_point="dartenv_tpu_torch.envs.walker3d:DartWalker3dEnv",
    max_episode_steps=1000,
)

register(
    id="DartDog-v1",
    entry_point="dartenv_tpu_torch.envs.dog:DartDogEnv",
    max_episode_steps=1000,
)
