"""Env package exports: the batched Task layer's single-env `DartEnv` and
every env class."""
from dartenv_tpu_torch.envs.base import DartEnv, Task  # noqa: F401
from dartenv_tpu_torch.envs.cart_pole import (  # noqa: F401
    DartCartPoleEnv, DartCartPoleSwingUpEnv,
)
from dartenv_tpu_torch.envs.double_pendulum import (  # noqa: F401
    DartDoubleInvertedPendulumEnv,
)
from dartenv_tpu_torch.envs.reacher import DartReacherEnv  # noqa: F401
from dartenv_tpu_torch.envs.reacher2d import DartReacher2dEnv  # noqa: F401
from dartenv_tpu_torch.envs.hopper import DartHopperEnv  # noqa: F401
from dartenv_tpu_torch.envs.walker2d import DartWalker2dEnv  # noqa: F401
from dartenv_tpu_torch.envs.walker3d import DartWalker3dEnv  # noqa: F401
from dartenv_tpu_torch.envs.human_walker import (  # noqa: F401
    DartHumanWalkerEnv,
)
from dartenv_tpu_torch.envs.snake_7link import (  # noqa: F401
    DartSnake7LinkEnv,
)
from dartenv_tpu_torch.envs.dog import DartDogEnv  # noqa: F401
