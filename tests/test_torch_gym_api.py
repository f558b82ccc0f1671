"""PyTorch port, the gym layer: `make` for every registered id against the
JAX package's registrations (spaces, spec, episode caps, thresholds), the
seeding streams, TimeLimit and Monitor statistics beside the JAX
wrappers', and pickling of every env class.  The port's envs run on the
CPU (`device="cpu"`)."""
import json
import os
import pickle

import numpy as np
import pytest
import torch

import dartenv_tpu as jgym
import dartenv_tpu_torch as gym
import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.api import seeding as jseeding
from dartenv_tpu.api.wrappers import Monitor as JMonitor
from dartenv_tpu.api.wrappers import TimeLimit as JTimeLimit
from dartenv_tpu_torch.api import seeding
from dartenv_tpu_torch.api.wrappers import Monitor, TimeLimit

IDS = sorted(s.id for s in jgym.registry.all())


def test_registry_holds_the_same_ids():
    assert sorted(s.id for s in gym.registry.all()) == IDS
    assert len(IDS) == 11


@pytest.mark.parametrize("env_id", IDS)
def test_make_matches_jax_spec_and_spaces(env_id):
    """Spaces, spec, max_episode_steps, reward_threshold, control dt and
    render metadata equal the JAX env's (exactly)."""
    jenv = jgym.make(env_id)
    env = gym.make(env_id, device="cpu", dtype=torch.float64)
    assert isinstance(env, TimeLimit) and isinstance(jenv, JTimeLimit)
    assert env.spec.id == jenv.spec.id == env_id
    assert env.spec.max_episode_steps == jenv.spec.max_episode_steps
    assert env._max_episode_steps == jenv._max_episode_steps
    assert env.spec.reward_threshold == jenv.spec.reward_threshold
    for sp, jsp in ((env.action_space, jenv.action_space),
                    (env.observation_space, jenv.observation_space)):
        assert sp.shape == jsp.shape
        np.testing.assert_array_equal(sp.low, jsp.low)
        np.testing.assert_array_equal(sp.high, jsp.high)
    u, ju = env.unwrapped, jenv.unwrapped
    assert u.frame_skip == ju.frame_skip
    assert u.dt == pytest.approx(float(ju.dt), rel=1e-12)
    assert u.metadata == ju.metadata
    assert u.model.device == torch.device("cpu")
    assert u.model.dtype == torch.float64
    assert (u.model.n, u.model.nb) == (ju.model.n, ju.model.nb)


def test_make_defaults_to_the_card():
    """No device argument: the env is built on "cuda", which raises on a
    machine without a GPU instead of running on the CPU."""
    if torch.cuda.is_available():
        env = gym.make("DartCartPole-v1").unwrapped
        assert env.model.device.type == "cuda"
        assert env.model.dtype == torch.float32
        return
    with pytest.raises((RuntimeError, AssertionError)):
        gym.make("DartCartPole-v1")


@pytest.mark.parametrize("seed", [0, 1, 123, 2 ** 40 + 7])
def test_seeding_gives_the_jax_stream(seed):
    rng, s = seeding.np_random(seed)
    jrng, js = jseeding.np_random(seed)
    assert s == js
    np.testing.assert_array_equal(rng.uniform(size=16),
                                  jrng.uniform(size=16))
    assert seeding.hash_seed(seed) == jseeding.hash_seed(seed)
    assert seeding.create_seed("a string") == jseeding.create_seed(
        "a string")
    env = gym.make("DartCartPole-v1", device="cpu", dtype=torch.float64)
    assert env.seed(seed) == [seed]


def _drive(env, episodes, steps, action):
    env.seed(0)
    for _ in range(episodes):
        env.reset()
        for _ in range(steps):
            _, _, done, _ = env.step(action)
            if done:
                break


def _stats(directory):
    (name,) = [f for f in os.listdir(directory)
               if f.endswith(".stats.json")]
    with open(os.path.join(directory, name)) as f:
        return json.load(f)


def test_time_limit_and_monitor_write_the_jax_stats(tmp_path):
    """TimeLimit at 7 steps under Monitor, three episodes of cartpole with
    a constant push: the recorded rewards, lengths, types and env id equal
    the JAX wrappers' (timestamps aside)."""
    a = np.array([0.6])
    for tag, mk, TL, Mon in (("jax", jgym.make, JTimeLimit, JMonitor),
                             ("port", gym.make, TimeLimit, Monitor)):
        kw = {} if tag == "jax" else dict(device="cpu",
                                          dtype=torch.float64)
        inner = mk("DartCartPole-v1", **kw).unwrapped
        inner.spec = mk("DartCartPole-v1", **kw).spec
        env = Mon(TL(inner, max_episode_steps=7), str(tmp_path / tag),
                  force=True)
        _drive(env, 2, 10, a)
        env.seed(0)
        env.reset()
        for _ in range(60):
            if env.step(np.array([1.0]))[2]:
                break
        env.close()
    got, ref = _stats(tmp_path / "port"), _stats(tmp_path / "jax")
    for key in ("env_id", "episode_lengths", "episode_rewards",
                "episode_types"):
        assert got[key] == ref[key], key
    assert got["episode_lengths"] == [7, 7, 7]


def test_time_limit_step_before_reset_raises():
    env = gym.make("DartCartPole-v1", device="cpu")
    with pytest.raises(AssertionError):
        env.step(np.array([0.0]))


@pytest.mark.parametrize("env_id", IDS)
def test_pickle_roundtrip(env_id):
    """EzPickle keeps the device and dtype; a clone of the small envs
    steps like the original."""
    raw = gym.make(env_id, device="cpu", dtype=torch.float64).unwrapped
    clone = pickle.loads(pickle.dumps(raw))
    assert type(clone) is type(raw)
    assert clone.model.device == raw.model.device
    assert clone.model.dtype == torch.float64
    assert clone.observation_space.shape == raw.observation_space.shape
    assert clone.action_space.shape == raw.action_space.shape
    if env_id in ("DartCartPole-v1", "DartReacher2d-v1"):
        outs = []
        for e in (raw, clone):
            e.seed(3)
            o0 = e.reset()
            outs.append((o0,) + e.step(np.full(e.action_space.shape,
                                               0.5))[:2])
        for x, y in zip(*outs):
            np.testing.assert_array_equal(x, y)


def test_scoreboard_scores_like_jax(tmp_path):
    """Three monitored cartpole episodes driven to one side, scored
    locally by each package's scoreboard against the same benchmark: the
    same episodes and score."""
    from dartenv_tpu.api import benchmarks as jbench
    from dartenv_tpu.api import scoreboard as jscore
    from dartenv_tpu_torch.api import benchmarks, scoreboard

    evs = []
    for tag, mk, Mon, bench, score in (
            ("jax", jgym.make, JMonitor, jbench, jscore),
            ("port", gym.make, Monitor, benchmarks, scoreboard)):
        kw = {} if tag == "jax" else dict(device="cpu", dtype=torch.float64)
        d = str(tmp_path / tag)
        env = Mon(mk("DartCartPole-v1", **kw), d, force=True,
                  video_callable=False)
        env.seed(0)
        for _ in range(3):
            env.reset()
            for _ in range(500):
                if env.step(env.action_space.high)[2]:
                    break
        env.close()
        bid = "GymPortCartPole-v0"
        if bid not in bench.registry.benchmarks:
            bench.register_benchmark(
                id=bid, scorer=bench.ClipTo01ThenAverage(),
                tasks=[dict(env_id="DartCartPole-v1", trials=3,
                            reward_floor=0.0, reward_ceiling=1000.0)])
        evs.append(score.upload(d, algorithm_id="constant",
                                benchmark_id=bid))
    got, ref = (e["envs"]["DartCartPole-v1"] for e in evs[::-1])
    assert got["episodes"] == ref["episodes"] == 3
    assert got["benchmark_score"] == ref["benchmark_score"]
    with pytest.raises(gym.error.Error):
        scoreboard.upload(str(tmp_path / "empty"))


def test_perturbation_dice_follow_the_seed():
    """A task with random pushes: the DartEnv's torch.Generator (on the
    model's device) is seeded by seed(), so a seed replays its pushes;
    from the same reset, another generator seed pushes otherwise."""
    from dartenv_tpu_torch.envs import DartEnv
    from dartenv_tpu_torch.envs.hopper import make_hopper_task

    task = make_hopper_task(dtype=torch.float64, device="cpu")
    task.add_perturbation = True
    task.perturbation_parameters = (0.5, 30.0, 0, 5)
    env = DartEnv(task)
    assert env._generator.device == torch.device("cpu")
    runs = []
    for gseed in (4, 4, 5):
        env.seed(4)
        o = [env.reset()]
        env._generator.manual_seed(gseed)
        for _ in range(3):
            o.append(env.step(np.zeros(3))[0])
        runs.append(np.stack(o))
    env.seed(4)
    assert torch.equal(env._generator.get_state(),
                       torch.Generator().manual_seed(4).get_state())
    np.testing.assert_array_equal(runs[0], runs[1])
    np.testing.assert_array_equal(runs[0][0], runs[2][0])
    assert not np.array_equal(runs[0][1:], runs[2][1:])
