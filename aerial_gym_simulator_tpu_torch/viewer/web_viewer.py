"""Browser-based interactive viewer.

Counterpart of ``aerial_gym_simulator_tpu/viewer/web_viewer.py``. The
reference's interactive viewer is an Isaac Gym window with keyboard control
(``env_manager/IGE_viewer_control.py:16-296``). A host without a display
serves the view over HTTP instead: frames are rendered on the device by the
OfflineViewer's camera (K2 on the card), encoded as PNG and streamed to any
browser as multipart/x-mixed-replace; key presses in the page POST back into
LiveViewer's key map. No dependency beyond the standard library
(``http.server`` and a built-in PNG encoder).

Endpoints: ``/`` (the page), ``/frame.png`` (the latest frame), ``/stream``
(every frame), ``/status`` (JSON), ``POST /key`` (``{"key": ...}``).

Key map (LiveViewer's, plus the camera orbit):
  R        reset all envs
  P/space  pause / unpause
  F        follow mode toggle (chase camera <-> fixed)
  [ / ]    previous / next tracked env
  S        render-sync toggle
  arrows   orbit the camera around the target
  + / -    zoom in / out

Usage::

    WebViewer(env).run(port=8750)       # a blocking sim + serve loop
    python -m aerial_gym_simulator_tpu_torch.viewer.web_viewer [--cpu] [--port 8750]
"""

from __future__ import annotations

import json
import logging
import queue
import struct
import threading
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Optional

import numpy as np

from .live_viewer import LiveViewer

logger = logging.getLogger("web_viewer")


def encode_png(rgb: np.ndarray) -> bytes:
    """Minimal RGB8 PNG encoder (zlib stdlib only)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[i].tobytes() for i in range(h))

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


_PAGE = """<!doctype html>
<html><head><title>aerial_gym_simulator_tpu_torch viewer</title>
<style>
 body { background:#14151a; color:#d5d9e0; font:13px monospace; margin:0 }
 #wrap { display:flex; flex-direction:column; align-items:center; gap:8px;
         padding:12px }
 img { border:1px solid #333; image-rendering:pixelated; width:70vw }
 #hud { color:#8eb4ff } kbd { background:#262a33; padding:1px 5px;
        border-radius:3px }
</style></head>
<body><div id="wrap">
 <div>
  <kbd>R</kbd> reset <kbd>P</kbd> pause <kbd>F</kbd> follow
  <kbd>[</kbd>/<kbd>]</kbd> env <kbd>S</kbd> sync
  <kbd>arrows</kbd> orbit <kbd>+</kbd>/<kbd>-</kbd> zoom
 </div>
 <img id="view" src="/stream">
 <div id="hud">connecting...</div>
</div>
<script>
 document.addEventListener('keydown', (e) => {
   fetch('/key', {method:'POST', body: JSON.stringify({key: e.key})});
 });
 setInterval(async () => {
   const s = await (await fetch('/status')).json();
   document.getElementById('hud').textContent =
     `env ${s.env} | ${s.paused ? 'PAUSED' : 'running'} | mode ${s.mode}` +
     ` | sync ${s.sync} | ${s.fps.toFixed(1)} fps | step ${s.steps}`;
 }, 500);
</script></body></html>
"""


class WebViewer(LiveViewer):
    """LiveViewer semantics served over HTTP instead of a local window."""

    def __init__(self, env, action_fn: Optional[Callable] = None,
                 width: int = 480, height: int = 360, env_index: int = 0,
                 render_every: int = 2):
        super().__init__(env, action_fn=action_fn, width=width, height=height,
                         env_index=env_index, render_every=render_every,
                         backend="Agg")
        self._frame_lock = threading.Condition()
        self._png: Optional[bytes] = None
        self._frame_no = 0
        self._steps = 0
        self._fps = 0.0
        self.server_address = None      # (host, port) once run() serves
        # key events arrive on HTTP handler threads but are applied on the
        # sim thread: on_key changes the env (reset() replaces the state
        # env.step is consuming) and the camera; the handler only enqueues,
        # step_once drains
        self._keys: "queue.SimpleQueue[str]" = queue.SimpleQueue()
        # orbit state (the camera offset)
        self._azim = 0.0
        self._elev = 0.35
        self._dist = float(np.linalg.norm(self.viewer.camera_position))

    # -- camera orbit ------------------------------------------------------
    def _orbit(self, d_azim=0.0, d_elev=0.0, d_dist=0.0):
        self._azim += d_azim
        self._elev = float(np.clip(self._elev + d_elev, -1.3, 1.3))
        self._dist = float(np.clip(self._dist + d_dist, 0.5, 50.0))
        ce, se = np.cos(self._elev), np.sin(self._elev)
        ca, sa = np.cos(self._azim), np.sin(self._azim)
        self.viewer.camera_position = self._dist * np.array([-ce * ca, -ce * sa, se],
                                                            np.float32)

    def on_key(self, key: Optional[str]):
        if key is None:
            return
        k = key.lower()
        if k in ("arrowleft", "left"):
            self._orbit(d_azim=0.15)
        elif k in ("arrowright", "right"):
            self._orbit(d_azim=-0.15)
        elif k in ("arrowup", "up"):
            self._orbit(d_elev=0.1)
        elif k in ("arrowdown", "down"):
            self._orbit(d_elev=-0.1)
        elif k in ("+", "="):
            self._orbit(d_dist=-0.5)
        elif k in ("-", "_"):
            self._orbit(d_dist=0.5)
        else:
            super().on_key(key)

    def step_once(self):
        # apply queued browser key events on THIS (sim) thread first
        while True:
            try:
                self.on_key(self._keys.get_nowait())
            except queue.Empty:
                break
        return super().step_once()

    # -- serving -----------------------------------------------------------
    def _publish(self, frame: np.ndarray):
        png = encode_png(np.ascontiguousarray(frame))
        with self._frame_lock:
            self._png = png
            self._frame_no += 1
            self._frame_lock.notify_all()

    def _make_handler(viewer):  # noqa: N805 — bound-class pattern
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet
                pass

            def do_GET(self):
                if self.path == "/":
                    body = _PAGE.encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "text/html")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/status":
                    body = json.dumps({
                        "env": viewer.env_index, "paused": viewer.paused,
                        "mode": viewer.viewer.mode, "sync": viewer.sync,
                        "fps": viewer._fps, "steps": viewer._steps,
                    }).encode()
                    self.send_response(200)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/frame.png":
                    with viewer._frame_lock:
                        png = viewer._png
                    if png is None:
                        self.send_response(503)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", "image/png")
                    self.send_header("Content-Length", str(len(png)))
                    self.end_headers()
                    self.wfile.write(png)
                elif self.path == "/stream":
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "multipart/x-mixed-replace; boundary=frame")
                    self.end_headers()
                    last = -1
                    try:
                        while not viewer.quit:
                            with viewer._frame_lock:
                                if viewer._frame_no == last:
                                    viewer._frame_lock.wait(timeout=1.0)
                                png = viewer._png
                                last = viewer._frame_no
                            if png is None:
                                continue
                            self.wfile.write(b"--frame\r\n")
                            self.wfile.write(b"Content-Type: image/png\r\n")
                            self.wfile.write(
                                f"Content-Length: {len(png)}\r\n\r\n".encode())
                            self.wfile.write(png)
                            self.wfile.write(b"\r\n")
                    except (BrokenPipeError, ConnectionResetError):
                        pass
                else:
                    self.send_response(404)
                    self.end_headers()

            def do_POST(self):
                if self.path == "/key":
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        key = json.loads(self.rfile.read(n)).get("key")
                    except (ValueError, AttributeError):
                        key = None
                    if key is not None:
                        viewer._keys.put(key)  # applied on the sim thread
                    self.send_response(204)
                    self.end_headers()
                else:
                    self.send_response(404)
                    self.end_headers()

        return Handler

    def run(self, port: int = 8750, max_steps: Optional[int] = None,
            host: str = "127.0.0.1", max_paused_s: float = 600.0):
        """Blocking loop: simulate and render on this thread, serve frames
        from daemon threads.

        max_steps counts SIM steps (frozen while paused); bounded runs
        (scripted captures, tests) additionally terminate after
        ``max_paused_s`` cumulative seconds spent paused so a forgotten
        pause cannot make a bounded run loop forever."""
        import time

        server = ThreadingHTTPServer((host, port), self._make_handler())
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        self.server_address = server.server_address
        logger.info("web viewer at http://%s:%d/ (R reset | P pause | F follow | [ ] env | "
                    "S sync | arrows orbit | +/- zoom)", *server.server_address[:2])
        t_last = time.perf_counter()
        paused_s = 0.0
        try:
            while not self.quit and (max_steps is None
                                     or (self._steps < max_steps
                                         and paused_s < max_paused_s)):
                frame = self.step_once()
                if not self.paused:
                    self._steps += 1  # sim steps, frozen while paused
                if frame is not None:
                    self._publish(frame)
                    now = time.perf_counter()
                    self._fps = 0.9 * self._fps + 0.1 / max(now - t_last, 1e-6)
                    t_last = now
                if self.paused:
                    time.sleep(0.05)
                    paused_s += 0.05
        finally:
            self.quit = True
            with self._frame_lock:
                self._frame_lock.notify_all()
            server.shutdown()


def main(argv=None):
    """``python -m aerial_gym_simulator_tpu_torch.viewer.web_viewer``: build
    an env (on CUDA unless ``--cpu``) and serve it until interrupted."""
    import argparse

    from ..sim.sim_builder import SimBuilder

    p = argparse.ArgumentParser(prog="python -m aerial_gym_simulator_tpu_torch.viewer.web_viewer")
    p.add_argument("--sim", default="base_sim")
    p.add_argument("--env", default="env_with_obstacles")
    p.add_argument("--robot", default="base_quadrotor")
    p.add_argument("--controller", default="lee_attitude_control")
    p.add_argument("--num_envs", type=int, default=16)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8750)
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    args = p.parse_args(argv)
    env = SimBuilder().build_env(args.sim, args.env, args.robot, args.controller,
                                 device="cpu" if args.cpu else None, num_envs=args.num_envs,
                                 seed=0)
    env.reset()
    WebViewer(env).run(port=args.port, max_steps=args.steps, host=args.host)


if __name__ == "__main__":
    main()
