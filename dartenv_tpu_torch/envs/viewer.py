"""Interactive `human`-mode viewer: a trackball window over the software
renderer.

The reference's human mode opens a GLUT window with a trackball camera
(`StaticGLUTWindow.runSingleStep()`; pydart2 `gui/glut/window.py` and
`gui/trackball.py`).  This viewer is built on the stdlib's Tk binding and
shows frames from the same pure-numpy rasterizer that serves `rgb_array`
(`envs/render.py`), at the window's size: no new dependencies, and
`render('human')` degrades to a recorded no-op on a headless host instead
of crashing.

Controls mirror the reference trackball:

* left-drag   — orbit (azimuth / elevation)
* right-drag / scroll / ``+``/``-`` — zoom (dolly the camera distance)
* arrow keys  — orbit in 5° steps
* ``t``       — toggle COM tracking on/off
* ``r``       — reset the camera to the env's default
* ``q`` / Escape / window close — close the viewer (subsequent
  `render('human')` calls become no-ops until `close=True` resets it)

The camera math lives in :class:`TrackballController`, Tk-free, so the
interaction model is unit-testable headless; :class:`InteractiveViewer`
is only the thin Tk shell around it.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from dartenv_tpu_torch.envs.render import Camera

logger = logging.getLogger(__name__)

# deg of orbit per pixel of drag — the reference trackball maps a
# half-window drag to ~90° of rotation; 0.4°/px matches that feel at the
# default 640-px window.
_ORBIT_DEG_PER_PX = 0.4
_ZOOM_PER_PX = 1.01          # right-drag: distance *= this ** dy
_ZOOM_PER_NOTCH = 1.12       # scroll wheel / +/- keys


def frame_to_ppm(frame: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 frame as a binary PPM (P6) blob.

    Tk's PhotoImage consumes PPM natively, which keeps the viewer free of
    PIL/Pillow.  Exposed at module level so the encoding is testable
    without a display.
    """
    frame = np.ascontiguousarray(frame, dtype=np.uint8)
    if frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) uint8 frame, got {frame.shape}")
    h, w = frame.shape[:2]
    return b"P6 %d %d 255\n" % (w, h) + frame.tobytes()


class TrackballController:
    """Maps pointer gestures onto a `render.Camera` (Tk-free).

    Reference: pydart2 ``gui/trackball.py`` drag→quaternion orbit and
    ``zoom_to`` dolly; here the orbit is the azimuth/elevation
    parameterization the software renderer's `Camera` already uses.
    """

    def __init__(self, camera: Camera | None = None):
        self.camera = camera if camera is not None else Camera()
        self._home = dataclasses.replace(
            self.camera, lookat_offset=np.array(self.camera.lookat_offset))

    def orbit(self, dx_px: float, dy_px: float) -> None:
        """Left-drag by (dx, dy) pixels: orbit about the look-at point."""
        self.camera.azimuth = (self.camera.azimuth
                               + dx_px * _ORBIT_DEG_PER_PX) % 360.0
        # dragging upward (dy < 0) looks further down, like the reference
        self.camera.elevation = float(np.clip(
            self.camera.elevation - dy_px * _ORBIT_DEG_PER_PX, -89.0, 89.0))

    def zoom(self, factor: float) -> None:
        """Multiply the camera distance (>1 zooms out, <1 zooms in)."""
        self.camera.distance = float(
            np.clip(self.camera.distance * factor, 0.2, 100.0))

    def drag_zoom(self, dy_px: float) -> None:
        """Right-drag: dolly proportionally to vertical motion."""
        self.zoom(_ZOOM_PER_PX ** dy_px)

    def toggle_track(self) -> None:
        self.camera.track = not self.camera.track

    def reset(self) -> None:
        home = self._home
        self.camera.azimuth = home.azimuth
        self.camera.elevation = home.elevation
        self.camera.distance = home.distance
        self.camera.track = home.track
        self.camera.lookat_offset = np.array(home.lookat_offset)


def _open_tk_root():
    """Create a withdrawn-then-shown Tk root, or None on a headless host."""
    try:
        import tkinter
    except Exception as exc:                      # pragma: no cover
        logger.warning("human-mode render unavailable: tkinter missing "
                       "(%s)", exc)
        return None, None
    try:
        root = tkinter.Tk()
    except tkinter.TclError as exc:
        logger.warning(
            "human-mode render unavailable on this host (no display: %s); "
            "use mode='rgb_array' or the Monitor video recorder instead.",
            exc)
        return None, None
    return tkinter, root


class InteractiveViewer:
    """Tk window mirroring the reference `StaticGLUTWindow` human mode.

    `imshow(frame)` is the `runSingleStep()` analogue: push one frame,
    pump the event queue (so drags/keys are handled between env steps),
    return.  Construction on a display-less host raises `RuntimeError`;
    callers should use :func:`create_viewer` which returns None instead.
    """

    def __init__(self, width: int, height: int, camera: Camera | None = None,
                 title: str = "dartenv_tpu_torch"):
        tkinter, root = _open_tk_root()
        if root is None:
            raise RuntimeError("no display available for human-mode render")
        self._tk = tkinter
        self.root = root
        self.trackball = TrackballController(camera)
        self.is_open = True
        self._drag_btn = None
        self._drag_xy = (0, 0)

        root.title(title)
        root.resizable(False, False)
        self.width, self.height = int(width), int(height)
        # a blank image of the window's size: a Label holding an image is
        # sized in pixels (without one, width/height count characters)
        self._photo = tkinter.PhotoImage(width=self.width,
                                         height=self.height)
        self.label = tkinter.Label(root, image=self._photo)
        self.label.pack()

        root.protocol("WM_DELETE_WINDOW", self.close)
        root.bind("<ButtonPress-1>", lambda e: self._press(1, e))
        root.bind("<ButtonPress-3>", lambda e: self._press(3, e))
        root.bind("<ButtonRelease-1>", lambda e: self._release())
        root.bind("<ButtonRelease-3>", lambda e: self._release())
        root.bind("<B1-Motion>", self._motion)
        root.bind("<B3-Motion>", self._motion)
        root.bind("<MouseWheel>", self._wheel)          # Windows/macOS
        root.bind("<Button-4>", lambda e: self.trackball.zoom(
            1.0 / _ZOOM_PER_NOTCH))                     # X11 scroll up
        root.bind("<Button-5>", lambda e: self.trackball.zoom(
            _ZOOM_PER_NOTCH))                           # X11 scroll down
        root.bind("<Key>", self._key)

    # -- event handlers ---------------------------------------------------
    def _press(self, btn, event):
        self._drag_btn = btn
        self._drag_xy = (event.x, event.y)

    def _release(self):
        self._drag_btn = None

    def _motion(self, event):
        if self._drag_btn is None:
            return
        dx = event.x - self._drag_xy[0]
        dy = event.y - self._drag_xy[1]
        self._drag_xy = (event.x, event.y)
        if self._drag_btn == 1:
            self.trackball.orbit(dx, dy)
        else:
            self.trackball.drag_zoom(dy)

    def _wheel(self, event):
        self.trackball.zoom(
            1.0 / _ZOOM_PER_NOTCH if event.delta > 0 else _ZOOM_PER_NOTCH)

    def _key(self, event):
        sym = event.keysym
        if sym in ("q", "Escape"):
            self.close()
        elif sym in ("plus", "equal"):
            self.trackball.zoom(1.0 / _ZOOM_PER_NOTCH)
        elif sym == "minus":
            self.trackball.zoom(_ZOOM_PER_NOTCH)
        elif sym == "Left":
            self.trackball.orbit(-5.0 / _ORBIT_DEG_PER_PX * 1.0, 0)
        elif sym == "Right":
            self.trackball.orbit(5.0 / _ORBIT_DEG_PER_PX * 1.0, 0)
        elif sym == "Up":
            self.trackball.orbit(0, -5.0 / _ORBIT_DEG_PER_PX * 1.0)
        elif sym == "Down":
            self.trackball.orbit(0, 5.0 / _ORBIT_DEG_PER_PX * 1.0)
        elif sym == "t":
            self.trackball.toggle_track()
        elif sym == "r":
            self.trackball.reset()

    # -- public surface ---------------------------------------------------
    @property
    def camera(self) -> Camera:
        return self.trackball.camera

    def imshow(self, frame: np.ndarray) -> None:
        """Display one frame and pump pending UI events (non-blocking)."""
        if not self.is_open:
            return
        self._photo = self._tk.PhotoImage(data=frame_to_ppm(frame))
        self.label.configure(image=self._photo,
                             width=frame.shape[1], height=frame.shape[0])
        try:
            self.root.update_idletasks()
            self.root.update()
        except self._tk.TclError:       # window destroyed mid-update
            self.is_open = False

    def close(self) -> None:
        if not self.is_open:
            return
        self.is_open = False
        try:
            self.root.destroy()
        except Exception:               # pragma: no cover
            pass


def create_viewer(width: int, height: int, camera: Camera | None = None,
                  title: str = "dartenv_tpu_torch"):
    """InteractiveViewer, or None (with a logged warning) when headless."""
    try:
        return InteractiveViewer(width, height, camera=camera, title=title)
    except RuntimeError:
        return None


def launch(world, max_steps: int | None = None, render_every: int = 1,
           width: int = 640, height: int = 480) -> bool:
    """Step a world in an interactive window until it is closed.

    pydart2-parity surface (`pydart2.gui.viewer.launch(world)`, the
    porting-era "watch the sim" entry point): accepts a
    `facade.WorldFacade` (steps one PHYSICS substep per frame through
    `world.step()`, like the reference GLUT idle callback) or a `DartEnv`
    (steps one zero-torque CONTROL step per frame).  Returns False
    immediately on a display-less host, True after the window closes or
    `max_steps` frames.
    """
    from dartenv_tpu_torch.envs.render import render_frame

    env = getattr(world, "_env", world)
    env = getattr(env, "unwrapped", env)
    if env._state is None:
        env.reset()
    viewer = create_viewer(
        width, height, camera=getattr(env, "camera", None),
        title=type(env).__name__)
    if viewer is None:
        return False
    zero_tau = None
    if not hasattr(world, "_env"):      # bare env: zero-action control steps
        import numpy as _np

        zero_tau = _np.zeros(env.action_space.shape)
    i = 0
    while viewer.is_open and (max_steps is None or i < max_steps):
        if zero_tau is None:
            world.step()                # facade: one physics substep
        else:
            env.step(zero_tau)
        if i % render_every == 0:
            frame = render_frame(
                env.model, env._state.sim, width=width, height=height,
                camera=viewer.camera,
                track_body=getattr(env.task, "torso_body", None))
            viewer.imshow(frame)
        i += 1
    viewer.close()
    return True
