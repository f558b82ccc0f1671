"""Task layer: a per-environment bundle of functions (action -> tau, obs,
reward, done, reset) over a SkelModel, and the fused batched env step.

Behavioral invariants (the reference's DartEnv): action clamped to
control_bounds BEFORE scaling; tau applied to the full dof vector with root
dofs zeroed; same tau for every frame_skip substep; reward dt =
sim_dt * frame_skip; termination on the post-step state; reset perturbs
the skel-file default pose.

Everything here is batch-first: hooks take and return (B, ...) tensors.
`DartEnv` is the single-env, numpy-in / numpy-out gym 0.9.x class over a
Task: one env is a batch of one, stepped by the same `make_env_step`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from dartenv_tpu_torch.api import core, error, seeding, spaces
from dartenv_tpu_torch.engine.world import (
    SimState, make_do_simulation, make_sim_step,
)
from dartenv_tpu_torch.model.skel_model import SkelModel
from dartenv_tpu_torch.utils.span import span


def with_solver(model: SkelModel, lcp_solver: Optional[str] = None,
                **overrides) -> SkelModel:
    """Override SolverConfig fields on a model (task-factory plumbing)."""
    if lcp_solver is not None:
        overrides["solver"] = lcp_solver
    if not overrides:
        return model
    return model.replace(
        solver=dataclasses.replace(model.solver, **overrides))


@dataclasses.dataclass(frozen=True)
class EnvState:
    """Complete state of a batch of envs for the functional path.

    The JAX package's EnvState carries a per-env PRNG `key`; it has no
    counterpart here: randomness comes from an explicit `torch.Generator`
    (or from noise tensors) handed to `reset` / `step`."""

    sim: SimState
    aux: Any         # task-specific tensors (empty tuple when unused)
    steps: Any       # (B,) int32 episode step counter


class Task:
    """Function bundle for one environment family; hooks are batch-first."""

    name: str = "task"
    frame_skip: int = 1
    obs_size: int = 0
    # (2, m): row 0 = upper, row 1 = lower
    control_bounds: np.ndarray = np.zeros((2, 0))
    # reset noise: uniform(-s, s) added to q_init / dq_init
    reset_noise: float = 0.01
    # random external perturbation (the reference DartEnv's
    # add_perturbation / perturbation_parameters = [prob, magnitude,
    # body_id, duration]): per substep, an env not being pushed starts a
    # push with probability `prob`, of `magnitude` N along +-x or +-y on
    # body `body_id`, for `duration` substeps
    add_perturbation: bool = False
    perturbation_parameters = (0.05, 30.0, 0, 40)
    # carry LCP impulses across substeps to warm-start the solver
    warm_start: bool = True

    def __init__(self, model: SkelModel):
        self.model = model
        self._lcp_rows = None

    def lam_init(self, batch: int):
        """Zero LCP-impulse carry enabling warm starts (or None when
        disabled / the model has no constraint rows)."""
        if not self.warm_start:
            return None
        if self._lcp_rows is None:
            from dartenv_tpu_torch.engine.constraints import build_layout
            self._lcp_rows = build_layout(self.model).m
        if self._lcp_rows == 0:
            return None
        return self.model.q_init.new_zeros((batch, self._lcp_rows))

    def action_to_tau(self, a, aux):
        raise NotImplementedError

    def obs(self, sim: SimState, aux):
        raise NotImplementedError

    def reward(self, sim_prev: SimState, sim: SimState, a, contacts, aux):
        raise NotImplementedError

    def done(self, sim: SimState, aux):
        raise NotImplementedError

    def aux_init(self, batch: int):
        """Initial aux of a batch: the perturbation state (force (B, 3) and
        remaining substeps `perturb_ttl` (B,) int32) when perturbations are
        on, else an empty tuple."""
        if self.add_perturbation:
            m = self.model
            return {"perturb_force": m.q_init.new_zeros((batch, 3)),
                    "perturb_ttl": torch.zeros(batch, dtype=torch.int32,
                                               device=m.device)}
        return ()

    def aux_reset(self, aux, generator=None):
        """Task state drawn anew on reset, from `generator` (the reacher's
        target); the default keeps `aux_init`'s."""
        return aux

    def perturb_noise_sample(self, batch: int, generator=None):
        """The perturbation dice of one control step, per substep and env:
        (u (S, B) uniform in [0, 1), axis (S, B) int64 in {0, 1}, sign
        (S, B) in {-1, +1}), S = frame_skip, drawn from `generator`."""
        shape = (self.frame_skip, batch)
        dev = self.model.device
        u = torch.rand(shape, generator=generator, device=dev,
                       dtype=self.model.dtype)
        axis = torch.randint(0, 2, shape, generator=generator, device=dev)
        sign = torch.randint(0, 2, shape, generator=generator,
                             device=dev).to(self.model.dtype) * 2 - 1
        return u, axis, sign

    def reset_noise_sample(self, batch: int, generator=None):
        """(2, B, n) uniform(-s, s) noise for (q, dq), drawn on the model's
        device from `generator` (a torch.Generator on that device)."""
        m = self.model
        u = torch.rand((2, batch, m.n), generator=generator,
                       device=m.device, dtype=m.dtype)
        return (2.0 * u - 1.0) * self.reset_noise

    def reset_sim(self, batch: int, generator=None, noise=None) -> SimState:
        """q, dq = defaults + U(-s, s).  `noise` ((2, B, n), already scaled)
        replaces the draw, so a test can hand the same numbers to another
        implementation."""
        m = self.model
        if noise is None:
            noise = self.reset_noise_sample(batch, generator)
        noise = torch.as_tensor(noise, device=m.device, dtype=m.dtype)
        return SimState(q=m.q_init + noise[0], dq=m.dq_init + noise[1],
                        time=m.q_init.new_zeros(batch),
                        lam=self.lam_init(batch))

    def np_reset_sim(self, np_random):
        """The single-env reset of the gym path, seed for seed with the
        reference's reset_model: q, dq (n,) numpy = defaults +
        uniform(-s, s) from `np_random`, drawn on q then dq."""
        m = self.model
        s = self.reset_noise
        q = m.host("q_init") + np_random.uniform(low=-s, high=s, size=m.n)
        dq = m.host("dq_init") + np_random.uniform(low=-s, high=s, size=m.n)
        return q, dq

    def np_reset_aux(self, np_random, aux):
        """Task state of a single env drawn anew on reset from `np_random`
        (aux: aux_init(1)); the default keeps it."""
        return aux

    @property
    def dt(self) -> float:
        """Control dt = sim dt * frame_skip."""
        return self.model.dt * self.frame_skip

    @property
    def action_size(self) -> int:
        return self.control_bounds.shape[1]


def make_env_step(task: Task):
    """Fused batched env step: (EnvState, actions (B, m), generator=None,
    perturb_noise=None) -> (EnvState, obs, reward, done, step_info),
    frame_skip substeps inside.

    With `task.add_perturbation` the dice are rolled once per substep (the
    reference's granularity), from `generator` or from `perturb_noise`
    (the (u, axis, sign) of Task.perturb_noise_sample, handed in so a test
    can give another implementation the same numbers), and every substep
    takes the external-force route of the sim step.  step_info holds
    `contact_overflow` (B,) and, with perturbations,
    `perturb_env_share` (frame_skip,): the share of envs pushed in each
    substep.  Its parts run in the spans `env.action`, `env.push` (each
    substep's push bookkeeping), `env.obs`, `env.reward` and `env.done`
    (utils/span.py)."""
    model = task.model
    perturb = task.add_perturbation
    if perturb:
        sub_step = make_sim_step(model)
    else:
        do_sim = make_do_simulation(model, task.frame_skip)
    hi = torch.as_tensor(task.control_bounds[0], dtype=model.dtype,
                         device=model.device)
    lo = torch.as_tensor(task.control_bounds[1], dtype=model.dtype,
                         device=model.device)
    prob, mag, body_id, duration = task.perturbation_parameters

    def perturbed_sim(sim, tau, aux, noise):
        """frame_skip substeps with a per-substep push; returns (sim,
        contacts, aux, the share of envs pushed in each substep)."""
        u, axis, sign = noise
        force, ttl = aux["perturb_force"], aux["perturb_ttl"]
        B = force.shape[0]
        overflow, pushed = None, []
        for k in range(task.frame_skip):
            with span("env.push"):
                start = (ttl <= 0) & (u[k] < prob)
                fresh = torch.zeros_like(force).scatter_(
                    1, axis[k][:, None], (sign[k] * mag)[:, None])
                live = ttl > 0
                force = torch.where(
                    start[:, None], fresh,
                    torch.where(live[:, None], force,
                                torch.zeros_like(force)))
                ttl = torch.where(start, torch.full_like(ttl, duration),
                                  torch.clamp(ttl - 1, min=0))
                pushed.append(torch.mean((force != 0).any(dim=1).to(
                    force.dtype)))
                f_ext = force.new_zeros((B, model.nb, 6))
                f_ext[:, body_id, 3:] = force
            sim, contacts = sub_step(sim, tau, f_ext)
            overflow = (contacts.overflow if overflow is None
                        else torch.maximum(overflow, contacts.overflow))
        contacts = dataclasses.replace(contacts, overflow=overflow)
        return sim, contacts, dict(aux, perturb_force=force,
                                   perturb_ttl=ttl), torch.stack(pushed)

    def env_step(state: EnvState, action, generator=None,
                 perturb_noise=None):
        with span("env.action"):
            a = torch.minimum(torch.maximum(action, lo), hi)
            tau = task.action_to_tau(a, state.aux)
        aux = state.aux
        step_info = {}
        if perturb:
            if perturb_noise is None:
                perturb_noise = task.perturb_noise_sample(a.shape[0],
                                                          generator)
            sim_new, contacts, aux, pushed = perturbed_sim(
                state.sim, tau, aux, perturb_noise)
            step_info["perturb_env_share"] = pushed
        else:
            sim_new, contacts = do_sim(state.sim, tau)
        # contact_overflow > 0: the active-set cap dropped contacts
        step_info["contact_overflow"] = contacts.overflow
        with span("env.obs"):
            obs = task.obs(sim_new, aux)
        with span("env.reward"):
            reward = task.reward(state.sim, sim_new, a, contacts, aux)
        with span("env.done"):
            done = task.done(sim_new, aux)
        new_state = EnvState(sim=sim_new, aux=aux, steps=state.steps + 1)
        return new_state, obs, reward, done, step_info

    return env_step


def make_env_reset(task: Task):
    """Batched reset: (batch, generator=None, noise=None) ->
    (EnvState, obs)."""
    def env_reset(batch: int, generator=None, noise=None):
        aux = task.aux_reset(task.aux_init(batch), generator)
        sim = task.reset_sim(batch, generator, noise)
        state = EnvState(
            sim=sim, aux=aux,
            steps=torch.zeros(batch, dtype=torch.int32,
                              device=task.model.device))
        return state, task.obs(sim, aux)

    return env_reset


class _CustomTask(Task):
    """Task shell for reference-style custom env subclasses, which override
    `_step` / `reset_model` / `_get_obs` on the env and drive the sim
    through `do_simulation` and `robot_skeleton`; the batched hooks here
    only run when the subclass keeps the default `_step`."""

    def __init__(self, model: SkelModel, frame_skip: int, obs_size: int,
                 control_bounds):
        super().__init__(model)
        self.frame_skip = int(frame_skip)
        self.obs_size = int(obs_size)
        self.control_bounds = np.asarray(control_bounds, dtype=np.float64)

    def action_to_tau(self, a, aux):
        return a.new_zeros((a.shape[0], self.model.n))

    def obs(self, sim, aux):
        return sim.state_vector()[:, :self.obs_size]

    def reward(self, sim_prev, sim, a, contacts, aux):
        return sim.q.new_zeros(sim.q.shape[0])

    def done(self, sim, aux):
        return torch.zeros(sim.q.shape[0], dtype=torch.bool,
                           device=sim.q.device)


# Cached in `_viewer` once opening a window failed (headless host) or the
# user closed it: `render('human')` is then a cheap no-op instead of a new
# Tk attempt on every frame.
_HEADLESS = object()


class DartEnv(core.Env):
    """Single-env gym 0.9.x class over a Task: numpy in, numpy out.

    The env is a batch of one: its state is an EnvState of (1, ...)
    tensors on the task model's device, stepped by `make_env_step(task)`
    (so a float32 CUDA model runs the same kernels as a VecEnv), and each
    control step copies its results to the host once (`step` in the span
    `gym.step`, the copy in `gym.host_copy`, `reset` in `gym.reset`).

    Two construction modes:
      * `DartEnv(task)` — the built-in env families.
      * `DartEnv(model_paths, frame_skip, observation_size, action_bounds,
        dt=0.002, obs_type='parameter', ..., device=, dtype=)` — the
        reference signature, for users porting custom env subclasses: the
        subclass overrides `_step` (calling `self.do_simulation`),
        `reset_model` and `_get_obs`, and codes against
        `self.robot_skeleton` as with pydart2.

    Reset noise comes from `np_random` (the reference's seeding, seed for
    seed); the perturbation dice of a task with `add_perturbation` come
    from a torch.Generator on the model's device, seeded by `seed()`.
    """

    metadata = {"render.modes": ["human", "rgb_array"]}

    def __init__(self, task, frame_skip=None, observation_size=None,
                 action_bounds=None, dt=0.002, obs_type="parameter",
                 action_type="continuous", visualize=False,
                 disableViewer=True, screen_width=80, screen_height=45,
                 device="cuda", dtype=torch.float32):
        if not isinstance(task, Task):
            task = self._task_from_model_paths(
                task, frame_skip, observation_size, action_bounds, dt,
                device, dtype)
        self.obs_type = obs_type
        self.visualize = visualize and not disableViewer
        self.screen_width = screen_width
        self.screen_height = screen_height
        self.task = task
        self.model = task.model
        self.frame_skip = task.frame_skip
        self._env_step = make_env_step(task)
        # do_simulation's steps per n_frames (validation tracers step one
        # frame at a time)
        self._do_sim_cache = {}
        self._generator = torch.Generator(device=task.model.device)

        self.action_space = spaces.Box(
            np.asarray(task.control_bounds[1], dtype=np.float64),
            np.asarray(task.control_bounds[0], dtype=np.float64),
            dtype=np.float64,
        )
        self.observation_space = spaces.Box(
            -np.inf * np.ones(task.obs_size),
            np.inf * np.ones(task.obs_size),
            dtype=np.float64,
        )
        self.metadata = {
            "render.modes": ["human", "rgb_array"],
            "video.frames_per_second": int(round(1.0 / self.dt)),
        }
        self._viewer = None
        self._seed()
        self._state = None
        # pydart2 facade (envs/facade.py): staged forces and commands, and
        # the last substep's manifold and impulses behind collision_result
        self._staged_tau = None
        self._staged_servo = None
        self._pending_fext = None
        self._last_contacts = None
        self._last_lam = None
        self._robot_skeleton = None
        self._world_facade = None

    @staticmethod
    def _task_from_model_paths(model_paths, frame_skip, observation_size,
                               action_bounds, dt, device="cuda",
                               dtype=torch.float32):
        """Reference-signature construction: parse the .skel, .urdf or
        .sdf file(s) and keep every mobile skeleton (the reference's
        World::step steps them all; `robot_skeleton = world.skeletons[-1]`,
        the last skeleton of the last file).  Several skeletons compose
        into one block-diagonal model (model/compose.py) with
        cross-skeleton contact pairs."""
        import os

        from dartenv_tpu_torch.model.compose import compose_models
        from dartenv_tpu_torch.model.sdf_loader import parse_sdf
        from dartenv_tpu_torch.model.skel_parser import (
            asset_path, parse_skel,
        )
        from dartenv_tpu_torch.model.urdf_loader import parse_urdf

        if frame_skip is None or observation_size is None \
                or action_bounds is None:
            raise error.Error(
                "DartEnv(model_paths, ...) requires frame_skip, "
                "observation_size and action_bounds (reference signature)")
        paths = [model_paths] if isinstance(model_paths, str) else \
            list(model_paths)
        models = []
        for p in paths:
            full = p if os.path.exists(p) else asset_path(p)
            if not os.path.exists(full):
                raise FileNotFoundError(f"DartEnv(model_paths): {p}")
            if full.endswith(".urdf"):
                models.append(parse_urdf(full, dtype=dtype, device=device))
            elif full.endswith(".sdf"):
                models.extend(parse_sdf(full, dtype=dtype,
                                        device=device).skeletons)
            else:
                models.extend(parse_skel(full, dtype=dtype,
                                         device=device).skeletons)
        # the constructor's dt overrides the files' <physics> dt (the
        # reference's `pydart.World(dt, path)`), on every model so the
        # composition's shared time step holds
        models = [m.replace(dt=float(dt)) if float(m.dt) != float(dt)
                  else m for m in models]
        model = compose_models(models) if len(models) > 1 else models[0]
        return _CustomTask(model, frame_skip, observation_size,
                           action_bounds)

    # -- host <-> device -------------------------------------------------
    def _tensor(self, x):
        """(1, ...) tensor of the model's dtype on its device (a copy)."""
        return torch.tensor(np.asarray(x, dtype=np.float64),
                            dtype=self.model.dtype,
                            device=self.model.device)[None]

    @staticmethod
    def _host(x):
        """One env's values of a (1, ...) tensor as float64 numpy (a
        copy)."""
        return x[0].detach().to("cpu", torch.float64, copy=True).numpy()

    # -- pydart2-style facade --------------------------------------------
    @property
    def robot_skeleton(self):
        if self._robot_skeleton is None:
            # a composed world's robot is its LAST skeleton
            self._robot_skeleton = self.world.skeletons[-1]
        return self._robot_skeleton

    @property
    def world(self):
        if self._world_facade is None:
            from dartenv_tpu_torch.envs.facade import WorldFacade
            self._world_facade = WorldFacade(self)
        return self._world_facade

    def _add_ext_force(self, body_id, force, offset=(0.0, 0.0, 0.0)):
        """Stage a world-frame force at a body-frame offset for the next
        do_simulation (reference: BodyNode.add_ext_force).  Torque about
        the body origin = (R offset) x F."""
        from dartenv_tpu_torch.dynamics.algorithms import fk_positions

        if self._pending_fext is None:
            self._pending_fext = np.zeros((self.model.nb, 6))
        R_w, _ = fk_positions(self.model, self._state.sim.q)
        arm = self._host(R_w)[body_id] @ np.asarray(offset,
                                                    dtype=np.float64)
        f = np.asarray(force, dtype=np.float64)
        self._pending_fext[body_id, :3] += np.cross(arm, f)
        self._pending_fext[body_id, 3:] += f

    def _collision_result(self):
        from dartenv_tpu_torch.engine.constraints import (
            build_layout, tangent_basis,
        )
        from dartenv_tpu_torch.envs.facade import CollisionResult, Contact

        contacts = self._last_contacts
        if contacts is None:
            # no step yet: collide at the current configuration
            from dartenv_tpu_torch.collision.narrowphase import collide
            from dartenv_tpu_torch.dynamics.algorithms import fk_positions
            R_w, p_w = fk_positions(self.model, self._state.sim.q)
            contacts = collide(self.model, R_w, p_w)
        layout = build_layout(self.model)
        active = self._host(contacts.active) > 0.5
        pos = self._host(contacts.pos)
        normal = self._host(contacts.normal)
        depth = self._host(contacts.depth)
        lam = (self._host(self._last_lam) if self._last_lam is not None
               else np.zeros(layout.m))
        # the full 3-vector force: the normal row and both friction rows,
        # on the tangent basis the LCP assembly used (pydart2's
        # contact.force is the full vector)
        t1, t2 = (t.numpy() for t in tangent_basis(torch.as_tensor(normal)))
        dt = float(self.model.dt)
        out = []
        for k in range(active.shape[0]):
            if not active[k]:
                continue
            f = (normal[k] * lam[3 * k] + t1[k] * lam[3 * k + 1]
                 + t2[k] * lam[3 * k + 2]) / dt
            out.append(Contact(pos[k], normal[k], f, float(depth[k]),
                               layout.slot_body[k]))
        return CollisionResult(out)

    # -- gym plumbing ----------------------------------------------------
    @property
    def dt(self):
        return self.task.dt

    def _seed(self, seed=None):
        self.np_random, seed = seeding.np_random(seed)
        self._generator.manual_seed(seed)
        return [seed]

    # -- state access (reference: set_state / state_vector) --------------
    def set_state(self, qpos, qvel):
        qpos, qvel = np.asarray(qpos), np.asarray(qvel)
        n = self.model.n
        assert qpos.shape == (n,) and qvel.shape == (n,)
        sim = SimState(
            q=self._tensor(qpos), dq=self._tensor(qvel),
            time=(self._state.sim.time if self._state is not None
                  else self.model.q_init.new_zeros(1)),
            # a teleport: the warm-start impulses restart at 0
            lam=self.task.lam_init(1))
        self._state = dataclasses.replace(self._state, sim=sim)

    def set_state_vector(self, s):
        n = self.model.n
        self.set_state(np.asarray(s[:n]), np.asarray(s[n:]))

    def state_vector(self):
        return self._host(self._state.sim.state_vector())

    # -- stepping --------------------------------------------------------
    def do_simulation(self, tau, n_frames):
        """Low-level parity hook: n_frames substeps with the raw
        generalized force `tau`, the staged servo commands and the forces
        staged by add_ext_force (cleared afterwards, as pydart2 does).
        Returns the last substep's Contacts."""
        do = self._do_sim_cache.get(n_frames)
        if do is None:
            do = self._do_sim_cache[n_frames] = make_do_simulation(
                self.model, n_frames, return_impulses=True)
        tau = np.asarray(tau, dtype=np.float64)
        if tau.shape[0] != self.model.n and self.model.skel_ranges:
            # composed world, robot-sized tau (the reference's
            # `robot_skeleton.set_forces(tau)` drives only the robot)
            _, _, _, d0, nd = self.model.skel_ranges[-1]
            if tau.shape[0] != nd:
                raise error.Error(
                    f"tau has {tau.shape[0]} dofs; expected the full "
                    f"world ({self.model.n}) or the robot skeleton ({nd})")
            full_tau = np.zeros(self.model.n)
            full_tau[d0:d0 + nd] = tau
            tau = full_tau
        fext = None
        if self._pending_fext is not None:
            fext = self._tensor(self._pending_fext)
            self._pending_fext = None
        servo = None
        if self._staged_servo is not None:
            servo = self._tensor(self._staged_servo)
        sim, (contacts, lam) = do(self._state.sim, self._tensor(tau), fext,
                                  servo)
        self._state = dataclasses.replace(self._state, sim=sim)
        self._last_contacts = contacts
        self._last_lam = lam
        return contacts

    def _step(self, action):
        with span("gym.step"):
            m = self.model
            a = self._tensor(np.asarray(action).reshape(-1))
            self._state, obs, reward, done, info = self._env_step(
                self._state, a, self._generator)
            # one copy to the host per control step: obs, reward, done and
            # the overflow count in one tensor
            with span("gym.host_copy"):
                vals = self._host(torch.cat([
                    obs, reward[:, None].to(m.dtype),
                    done[:, None].to(m.dtype),
                    info["contact_overflow"][:, None].to(m.dtype)], dim=1))
            k = obs.shape[1]
            info = {"contact_overflow": float(vals[k + 2])}
            if self.obs_type == "image":
                # image observations at the constructor's screen size (the
                # reference's obs_type='image', screen_width /
                # screen_height)
                obs_out = self._render(mode="rgb_array",
                                       width=self.screen_width,
                                       height=self.screen_height)
            else:
                obs_out = vals[:k]
            return obs_out, float(vals[k]), bool(vals[k + 1]), info

    def _new_state(self, sim, aux):
        self._state = EnvState(
            sim=sim, aux=aux,
            steps=torch.zeros(1, dtype=torch.int32,
                              device=self.model.device))

    def _reset(self):
        with span("gym.reset"):
            m = self.model
            if hasattr(self, "reset_model"):
                # the reference's custom-env flow: world.reset(), then the
                # subclass's reset_model() sets the state and returns obs
                self._new_state(SimState(
                    q=m.q_init[None].clone(), dq=m.dq_init[None].clone(),
                    time=m.q_init.new_zeros(1), lam=self.task.lam_init(1)),
                    self.task.aux_init(1))
                self._staged_tau = None
                self._pending_fext = None
                return self.reset_model()
            q, dq = self.task.np_reset_sim(self.np_random)
            aux = self.task.np_reset_aux(self.np_random,
                                         self.task.aux_init(1))
            sim = SimState(q=self._tensor(q), dq=self._tensor(dq),
                           time=m.q_init.new_zeros(1),
                           lam=self.task.lam_init(1))
            self._new_state(sim, aux)
            if self.obs_type == "image":
                return self._render(mode="rgb_array",
                                    width=self.screen_width,
                                    height=self.screen_height)
            return self._host(self.task.obs(sim, aux))

    def _close(self):
        # the owned window goes with the env (the reference's
        # Env.close() tears down its render)
        self._render(close=True)

    def _render(self, mode="human", close=False, width=None, height=None):
        if close:
            if self._viewer is not None:
                if self._viewer is not _HEADLESS:
                    self._viewer.close()
                self._viewer = None
            return
        from dartenv_tpu_torch.envs.render import render_frame

        # COM-tracked perspective camera; an env may set
        # `self.camera = render.Camera(...)` (the viewer_setup analogue).
        size = {}
        if width is not None:
            size["width"] = width
            # width alone keeps the renderer's 4:3 aspect
            size["height"] = (height if height is not None
                              else max(1, round(width * 3 / 4)))
        elif height is not None:
            size["height"] = height
        track = getattr(self.task, "torso_body", None)
        if mode == "human":
            # a stdlib-Tk window over the same rasterizer (envs/viewer.py),
            # at the window's size; on a headless host a recorded no-op
            viewer = self._get_viewer()
            if viewer is None:
                return None
            if not size:
                size = dict(width=getattr(viewer, "width", 640),
                            height=getattr(viewer, "height", 480))
            viewer.imshow(render_frame(self.model, self._state.sim,
                                       camera=viewer.camera,
                                       track_body=track, **size))
            if not viewer.is_open:
                self._viewer = _HEADLESS
            return None
        return render_frame(self.model, self._state.sim,
                            camera=getattr(self, "camera", None),
                            track_body=track, **size)

    def _get_viewer(self):
        """The interactive window, opened on first use (None while headless
        or closed); `render(close=True)` clears the cache."""
        if self._viewer is _HEADLESS:
            return None
        if self._viewer is None:
            from dartenv_tpu_torch.envs import viewer as _viewer_mod

            v = _viewer_mod.create_viewer(
                640, 480, camera=getattr(self, "camera", None),
                title=type(self).__name__)
            self._viewer = v if v is not None else _HEADLESS
            if v is None:
                return None
        return self._viewer
