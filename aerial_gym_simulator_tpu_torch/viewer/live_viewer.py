"""Live interactive viewer: the keyboard-driven counterpart of the
reference's Isaac Gym viewer (``env_manager/IGE_viewer_control.py:16-296``:
follow modes, reset-all, pause, env switching, sync toggle).

Counterpart of ``aerial_gym_simulator_tpu/viewer/live_viewer.py``. It shows
the OfflineViewer's chase or fixed camera in a matplotlib window and steps a
given env or task, with the reference viewer's key map:

  R        reset all envs
  P/space  pause / unpause
  F        toggle follow mode           (FOLLOW_ROBOT <-> FIXED)
  [ / ]    previous / next tracked env
  S        toggle render sync (render every frame or every Nth)
  Q/escape quit

The tracked env and the camera mode are plain attributes of the offline
viewer (JAX's ``_rejit`` has no counterpart: nothing is traced). On a host
without a display use OfflineViewer (PPM / AVI) or WebViewer; ``run()``
raises without a GUI backend unless ``backend="Agg"`` is forced (tests drive
``on_key`` / ``step_once`` directly).
"""

from __future__ import annotations

import logging
from typing import Callable, Optional

import numpy as np
import torch

from .offline_viewer import OfflineViewer

logger = logging.getLogger("live_viewer")


class LiveViewer:
    """Interactive window around a SimBuilder env or a task.

    env: an object with ``params``, ``state``, ``reset()`` and
         ``step(actions)`` (EnvManager and every task qualify); it runs on
         its params' device (CUDA unless it was built with device="cpu").
    action_fn: optional ``state -> actions``; zeros by default (a hover
         under an attitude controller).
    """

    def __init__(self, env, action_fn: Optional[Callable] = None, width: int = 320,
                 height: int = 240, env_index: int = 0, render_every: int = 2,
                 backend: Optional[str] = None):
        self.env = env
        self.action_fn = action_fn
        self.viewer = OfflineViewer(env.params, width=width, height=height, env_id=env_index)
        self.env_index = env_index
        self.paused = False
        self.sync = True            # render every frame
        self.render_every = render_every
        self.quit = False
        self._frame_i = 0
        self._backend = backend

    # -- keyboard handling (the reference's key map) ----------------------
    def on_key(self, key: Optional[str]):
        if key is None:
            return
        key = key.lower()
        if key == "r":
            self.env.reset()
            logger.info("viewer: reset all envs")
        elif key in ("p", " "):
            self.paused = not self.paused
            logger.info("viewer: %s", "paused" if self.paused else "running")
        elif key == "f":
            self.viewer.mode = "fixed" if self.viewer.mode == "follow_robot" else "follow_robot"
            logger.info("viewer: camera mode %s", self.viewer.mode)
        elif key in ("[", "]"):
            n = self.env.state.pos.shape[0]
            self.env_index = (self.env_index + (1 if key == "]" else -1)) % n
            self.viewer.env_id = self.env_index
            logger.info("viewer: tracking env %d", self.env_index)
        elif key == "s":
            self.sync = not self.sync
            logger.info("viewer: render sync %s", self.sync)
        elif key in ("q", "escape"):
            self.quit = True

    def _actions(self):
        if self.action_fn is not None:
            return self.action_fn(self.env.state)
        pos = self.env.state.pos
        return torch.zeros((pos.shape[0], self.env.params.controller.num_actions),
                           device=pos.device)

    def step_once(self) -> Optional[np.ndarray]:
        """Advance the sim one step (unless paused) and return a frame when
        one is due (sync, or every ``render_every`` steps)."""
        if not self.paused:
            self.env.step(self._actions())
        self._frame_i += 1
        if not (self.sync or self._frame_i % self.render_every == 0):
            return None
        return self.viewer.render(self.env.state, store=False)

    # -- window loop ------------------------------------------------------
    def run(self, max_steps: Optional[int] = None):
        import matplotlib
        if self._backend:
            matplotlib.use(self._backend)
        import matplotlib.pyplot as plt
        if not self._backend and matplotlib.get_backend().lower() == "agg":
            raise RuntimeError("no GUI matplotlib backend available: this host is headless; "
                               "use OfflineViewer (PPM / AVI) or WebViewer instead")

        fig, ax = plt.subplots(figsize=(6, 4.5))
        fig.canvas.manager.set_window_title("aerial_gym_simulator_tpu_torch")
        fig.canvas.mpl_connect("key_press_event", lambda e: self.on_key(e.key))
        im = ax.imshow(np.zeros((self.viewer.height, self.viewer.width, 3), np.uint8))
        ax.set_axis_off()
        ax.set_title("R reset | P pause | F follow | [ ] env | S sync | Q quit", fontsize=8)
        plt.ion()
        plt.show()
        steps = 0
        while not self.quit and (max_steps is None or steps < max_steps):
            frame = self.step_once()
            if frame is not None:
                im.set_data(frame)
                fig.canvas.draw_idle()
            plt.pause(0.001)
            steps += 1
        plt.close(fig)


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.viewer.live_viewer`` on a
    display host (CUDA unless ``--cpu``)."""
    import argparse

    from ..sim.sim_builder import SimBuilder

    p = argparse.ArgumentParser(prog="python -m aerial_gym_simulator_tpu_torch.viewer.live_viewer")
    p.add_argument("--sim", default="base_sim")
    p.add_argument("--env", default="env_with_obstacles")
    p.add_argument("--robot", default="base_quadrotor")
    p.add_argument("--controller", default="lee_attitude_control")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    args = p.parse_args(argv)
    env = SimBuilder().build_env(args.sim, args.env, args.robot, args.controller,
                                 device="cpu" if args.cpu else None, num_envs=args.num_envs,
                                 seed=0)
    env.reset()
    LiveViewer(env).run(max_steps=args.steps)


if __name__ == "__main__":
    main()
