"""PyTorch port, the renderer and the viewer: rgb_array frames equal the
JAX package's frames from the same state; a body behind the camera is
skipped, not drawn over the frame; the Tk viewer runs headless through a
monkeypatched `_open_tk_root`, renders human mode at the window's size,
and `env.close()` closes its window."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one PyTorch thread per test worker)
from dartenv_tpu.bench.throughput import make_task as jax_make_task
from dartenv_tpu.envs.base import DartEnv as JDartEnv
from dartenv_tpu.envs.render import Camera as JCamera
from dartenv_tpu_torch.envs import DartEnv, base, viewer
from dartenv_tpu_torch.envs.render import Camera, render_frame
from dartenv_tpu_torch.envs.tasks import make_task
from dartenv_tpu_torch.envs.viewer import (
    TrackballController, create_viewer, frame_to_ppm,
)


def _pair(name, seed=0):
    env = DartEnv(make_task(name, dtype=torch.float64, device="cpu"))
    jenv = JDartEnv(jax_make_task(name, dtype=jnp.float64))
    for e in (env, jenv):
        e.seed(seed)
        e.reset()
    return env, jenv


@pytest.mark.parametrize("name,cam", [
    ("hopper", None), ("walker3d", None), ("cartpole", None),
    ("dog", (35.0, -25.0, 3.0)), ("humanwalker", (200.0, -10.0, 5.0))])
def test_frame_equals_jax_frame(name, cam):
    """Capsules, boxes, the geom-less stick figure, and orbited cameras,
    at the reset state and at a perturbed one: every pixel of the port's
    frame equals the JAX frame."""
    env, jenv = _pair(name)
    if cam is not None:
        az, el, dist = cam
        env.camera = Camera(azimuth=az, elevation=el, distance=dist)
        jenv.camera = JCamera(azimuth=az, elevation=el, distance=dist)
    rng = np.random.default_rng(4)
    for _ in range(2):
        f = env.render(mode="rgb_array")
        jf = jenv.render(mode="rgb_array")
        assert f.shape == (240, 320, 3) and f.dtype == np.uint8
        np.testing.assert_array_equal(f, jf)
        n = env.model.n
        q = env.model.host("q_init") + rng.uniform(-0.3, 0.3, n)
        for e in (env, jenv):
            e.set_state(q, np.zeros(n))
    assert len(np.unique(f.reshape(-1, 3), axis=0)) >= 3
    f = env._render(mode="rgb_array", width=64)
    assert f.shape == (48, 64, 3)
    np.testing.assert_array_equal(f, jenv._render(mode="rgb_array",
                                                  width=64))


def test_primitives_behind_the_camera_are_skipped():
    """The cartpole's stick figure with each body 0.5 m behind the camera
    on its optical axis: the port skips it and shows the empty scene,
    where the JAX renderer's depth clamped to 1e-6 paints a disk of
    enormous radius over the whole frame."""
    from dartenv_tpu.envs.render import render_frame as jax_render_frame
    from dartenv_tpu_torch.dynamics.algorithms import fk_positions

    env, jenv = _pair("cartpole")
    p_w = fk_positions(env.model, env._state.sim.q)[1][0].numpy()
    empty = lambda f: np.all(f >= 170, axis=-1).mean()   # sky or ground
    for b in range(env.model.nb):
        kw = dict(azimuth=0.0, elevation=0.0, distance=1.0, track=False,
                  lookat_offset=p_w[b] - np.array([0.0, 0.0, 1.5]))
        f = render_frame(env.model, env._state.sim, camera=Camera(**kw))
        assert empty(f) == 1.0
        jf = jax_render_frame(jenv.model, jenv._state.sim,
                              camera=JCamera(**kw))
        assert empty(jf) < 0.5


def test_ppm_and_trackball():
    frame = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    header, _, payload = frame_to_ppm(frame).partition(b"\n")
    assert header == b"P6 3 2 255" and payload == frame.tobytes()
    with pytest.raises(ValueError):
        frame_to_ppm(np.zeros((2, 3), dtype=np.uint8))
    cam = Camera(azimuth=10.0, elevation=-12.0, distance=4.0)
    tb = TrackballController(cam)
    tb.orbit(25.0, -50.0)
    assert cam.azimuth == pytest.approx(20.0)
    assert cam.elevation == pytest.approx(8.0)
    tb.zoom(1e9)
    assert cam.distance == 100.0
    tb.toggle_track()
    assert not cam.track
    tb.reset()
    assert (cam.azimuth, cam.elevation, cam.distance, cam.track) == (
        10.0, -12.0, 4.0, True)


def test_headless_human_render_is_a_noop(monkeypatch):
    """_open_tk_root finds no display: create_viewer gives None,
    render('human') caches the headless sentinel and rgb_array still
    works; render(close=True) clears the cache."""
    monkeypatch.setattr(viewer, "_open_tk_root", lambda: (None, None))
    assert create_viewer(64, 48) is None
    env = DartEnv(make_task("cartpole", dtype=torch.float64, device="cpu"))
    env.reset()
    assert env.render(mode="human") is None
    assert env._viewer is base._HEADLESS
    assert env.render(mode="human") is None
    assert env.render(mode="rgb_array").shape == (240, 320, 3)
    env.render(close=True)
    assert env._viewer is None
    env.close()


class _FakeTk:
    """The parts of tkinter the viewer touches, recording what it does."""

    class TclError(Exception):
        pass

    class PhotoImage:
        def __init__(self, data=None, width=None, height=None):
            self.data, self.width, self.height = data, width, height

    class Label:
        def __init__(self, root, image=None, **kw):
            self.config = dict(kw, image=image)

        def pack(self):
            pass

        def configure(self, **kw):
            self.config.update(kw)

    class Root:
        def __init__(self):
            self.destroyed = False
            self.bound = []
            self.updates = 0

        def title(self, t):
            self.title_text = t

        def resizable(self, *a):
            pass

        def protocol(self, name, fn):
            self.on_close = fn

        def bind(self, ev, fn):
            self.bound.append(ev)

        def update_idletasks(self):
            pass

        def update(self):
            self.updates += 1

        def destroy(self):
            self.destroyed = True


def test_viewer_window_sized_in_pixels_and_closed_by_env_close(
        monkeypatch):
    """The Tk shell on a stand-in tkinter: the label holds a blank image
    of the window's size (pixels, not characters), human mode renders at
    that size and pumps the event loop, and env.close() destroys the
    window."""
    root = _FakeTk.Root()
    monkeypatch.setattr(viewer, "_open_tk_root", lambda: (_FakeTk, root))
    env = DartEnv(make_task("hopper", dtype=torch.float64, device="cpu"))
    env.seed(1)
    env.reset()
    assert env.render(mode="human") is None
    v = env._viewer
    assert isinstance(v, viewer.InteractiveViewer)
    assert (v.width, v.height) == (640, 480)
    assert "<ButtonPress-1>" in root.bound and root.updates == 1
    shown = v.label.config["image"]
    assert shown.data.startswith(b"P6 640 480 255\n")
    assert v.label.config["width"] == 640
    env.step(np.zeros(3))
    env.render(mode="human")
    assert root.updates == 2
    env.close()
    assert root.destroyed and not v.is_open and env._viewer is None


def test_launch_steps_the_world(monkeypatch):
    """launch(world): the facade's physics substeps, one frame each, until
    the window closes (after 3 frames here)."""
    frames = []

    class Counting:
        def __init__(self, camera):
            self.camera = camera if camera is not None else Camera()
            self.is_open = True

        def imshow(self, frame):
            frames.append(frame)
            self.is_open = len(frames) < 3

        def close(self):
            self.is_open = False

    monkeypatch.setattr(viewer, "create_viewer",
                        lambda w, h, camera=None, title="": Counting(camera))
    env = DartEnv(make_task("hopper", dtype=torch.float64, device="cpu"))
    env.reset()
    t0 = env.world.time
    assert viewer.launch(env.world, width=64, height=48) is True
    assert len(frames) == 3 and frames[0].shape == (48, 64, 3)
    assert env.world.time == pytest.approx(t0 + 3 * env.world.dt)
