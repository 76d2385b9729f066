"""Port parity for the viewers: the offline, live and web viewers against
the JAX package's (JAX tests/test_viewer.py:12-100).

The offline frames of both packages come from one state, carried across by
``sim/convert.py`` (``env_with_obstacles``, 4 envs, 64x48, a chase camera
near the robot so that the frame holds obstacles and the robot marker).
Tolerances: depth within 1e-4 m plus 3e-5 of the depth (the two packages
compose the obstacle transforms in different orders; the largest gap seen
is 1.6e-4 m on an edge pixel 7.2 m away), segmentation ids equal, the uint8
frames equal wherever the ids agree, the AVI files byte for byte. The web
viewer is polled with a deadline, never timed by a fixed sleep.
"""

import json
import os
import threading
import time
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder
from aerial_gym_simulator_tpu.viewer import OfflineViewer as JOfflineViewer

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.viewer import (LiveViewer, OfflineViewer, WebViewer,
                                                   encode_png)
from aerial_gym_simulator_tpu_torch.viewer import live_viewer, offline_viewer, web_viewer

N = 4
OBSTACLES = ("base_sim", "env_with_obstacles", "base_quadrotor", "lee_velocity_control")
EMPTY = ("base_sim", "empty_env", "base_quadrotor", "no_control")
SIZE = dict(width=64, height=48)
CHASE = (-1.0, 0.0, 0.4)
DEADLINE_S = 60.0


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def obstacle_envs():
    """The JAX env after 3 steps and the port's, holding its state."""
    jenv = JSimBuilder().build_env(*OBSTACLES, num_envs=N, seed=0)
    jenv.reset()
    for _ in range(3):
        jenv.step(jnp.zeros((N, 4)))
    tenv = port.SimBuilder().build_env(*OBSTACLES, device="cpu", num_envs=N, seed=0)
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=0)
    return jenv, tenv


def _frames(jenv, tenv, **kw):
    jv, tv = JOfflineViewer(jenv.params, **SIZE, **kw), OfflineViewer(tenv.params, **SIZE, **kw)
    jt, js = (np.asarray(x) for x in jv._render(jenv.state))
    tt, ts = (x.numpy() for x in tv._render(tenv.state))
    return (jt, js, jv.render(jenv.state)), (tt, ts, tv.render(tenv.state)), (jv, tv)


@pytest.mark.parametrize("env_id", range(N))
@pytest.mark.parametrize("mode", ["follow_robot", "fixed"])
def test_offline_frame_matches_jax(obstacle_envs, mode, env_id):
    jenv, tenv = obstacle_envs
    cam = CHASE if mode == "follow_robot" else (-1.5, 0.5, 0.6)
    (jt, js, jimg), (tt, ts, timg), _ = _frames(jenv, tenv, env_id=env_id, mode=mode,
                                                camera_position=cam)
    assert tt.shape == (48, 64) and ts.dtype == np.int32 and timg.dtype == np.uint8
    np.testing.assert_allclose(tt, jt, atol=1e-4, rtol=3e-5)
    np.testing.assert_array_equal(ts, js)
    # the chase camera sees obstacles and walls; the fixed one at least two walls
    assert len(np.unique(js)) > (3 if mode == "follow_robot" else 1), np.unique(js)
    agree = ts == js
    np.testing.assert_array_equal(timg[agree], jimg[agree])


def test_chase_camera_sees_the_robot_marker(obstacle_envs):
    jenv, tenv = obstacle_envs
    (_, js, _), (_, ts, _), _ = _frames(jenv, tenv, camera_position=CHASE)
    assert (ts == offline_viewer.ROBOT_SEG).sum() > 50
    np.testing.assert_array_equal(ts == -10, js == -10)


def test_viewer_renders_and_exports_like_jax(obstacle_envs, tmp_path):
    """JAX test_viewer.py:12-34: three frames, the AVI (byte for byte the
    JAX writer's on the same frames) and the PPM sequence."""
    jenv, tenv = obstacle_envs
    jv = JOfflineViewer(jenv.params, width=80, height=60)
    tv = OfflineViewer(tenv.params, width=80, height=60)
    for _ in range(3):
        jv.render(jenv.state)
        img = tv.render(tenv.state)
    assert img.shape == (60, 80, 3) and img.dtype == np.uint8
    jv.save_avi(str(tmp_path / "j.avi"), fps=5)
    tv.save_avi(str(tmp_path / "t.avi"), fps=5)
    t_bytes = (tmp_path / "t.avi").read_bytes()
    assert t_bytes[:4] == b"RIFF" and t_bytes[8:12] == b"AVI "
    assert len(t_bytes) > 3 * 80 * 60 * 3
    assert t_bytes == (tmp_path / "j.avi").read_bytes()
    tv.save_ppm_sequence(str(tmp_path / "frames"))
    assert len(os.listdir(tmp_path / "frames")) == 3
    tv.reset()
    with pytest.raises(ValueError, match="no frames"):
        tv.save_avi(str(tmp_path / "none.avi"))


def test_fixed_mode_and_empty_env_take_no_launch(monkeypatch):
    """JAX test_viewer.py:37-44, and the empty env casts nothing: the frame
    is the sky and the robot, equal to JAX's."""
    jenv = JSimBuilder().build_env(*EMPTY, num_envs=2, seed=0)
    jenv.reset()
    tenv = port.SimBuilder().build_env(*EMPTY, device="cpu", num_envs=2, seed=0)
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=0)
    calls = []
    monkeypatch.setattr(raycast_cuda, "raycast", lambda *a, **k: calls.append(1))
    kw = dict(mode="fixed", camera_position=(-3.0, 0.0, 1.0))
    (jt, js, jimg), (tt, ts, timg), (_, tv) = _frames(jenv, tenv, **kw)
    assert calls == [] and tv.cast_inputs(tenv.state) is None
    assert timg.shape == (48, 64, 3)
    np.testing.assert_array_equal(ts, js)
    np.testing.assert_allclose(tt, jt, atol=1e-4, rtol=3e-5)
    np.testing.assert_array_equal(timg, jimg)


def test_chase_camera_centers_robot():
    """JAX test_viewer.py:47-59: in the empty env the look-at basis puts
    the robot under the centre pixel (a sign slip mirrors the frame)."""
    tenv = port.SimBuilder().build_env(*EMPTY, device="cpu", num_envs=2, seed=0)
    tenv.reset()
    v = OfflineViewer(tenv.params, width=80, height=60)
    _, sem = v._render(tenv.state)
    sem = sem.numpy()
    assert (sem == -10).sum() > 0 and sem[30, 40] == -10


def test_live_viewer_keymap_and_stepping():
    """JAX test_viewer.py:62-100: pause stops stepping, [ / ] cycle the
    tracked env, F toggles the camera mode, S the sync, R resets, Q quits;
    step_once returns frames when due."""
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor",
                                      "lee_attitude_control", device="cpu", num_envs=4, seed=0)
    env.reset()
    lv = LiveViewer(env, width=64, height=48, backend="Agg")
    frame = lv.step_once()
    assert frame is not None and frame.shape == (48, 64, 3)

    lv.on_key("p")
    before = env.state.pos.clone()
    lv.step_once()
    assert torch.equal(env.state.pos, before)
    lv.on_key(" ")
    lv.step_once()
    assert not torch.equal(env.state.pos, before)

    lv.on_key("]")
    assert lv.env_index == 1 and lv.viewer.env_id == 1
    lv.on_key("[")
    lv.on_key("[")
    assert lv.env_index == 3                      # wraps around

    assert lv.viewer.mode == "follow_robot"
    lv.on_key("f")
    assert lv.viewer.mode == "fixed"

    lv.on_key("s")
    lv._frame_i = 0
    assert lv.step_once() is None                 # frame 1 of every 2
    assert lv.step_once() is not None

    lv.on_key("r")
    lv.on_key("q")
    assert lv.quit


def test_live_viewer_run_draws_on_agg():
    env = port.SimBuilder().build_env(*EMPTY, device="cpu", num_envs=2, seed=0)
    env.reset()
    lv = LiveViewer(env, width=32, height=24, backend="Agg")
    lv.run(max_steps=2)
    assert lv._frame_i == 2


def _poll(fn, what: str):
    deadline = time.time() + DEADLINE_S
    while time.time() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.01)
    pytest.fail(f"timed out waiting for {what}")


def test_web_viewer_serves_frames_and_keys():
    """The HTTP surface: /frame.png is a PNG, a /key POST reaches the key
    map on the sim thread, /status reports it; every wait polls against a
    deadline."""
    env = port.SimBuilder().build_env(*EMPTY, device="cpu", num_envs=2, seed=0)
    env.reset()
    wv = WebViewer(env, width=32, height=24)
    thread = threading.Thread(target=wv.run, kwargs=dict(port=0, max_steps=None), daemon=True)
    thread.start()
    try:
        host, port_ = _poll(lambda: wv.server_address, "the server")[:2]
        base = f"http://{host}:{port_}"

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=10) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, b""

        def key(k):
            req = urllib.request.Request(base + "/key", data=json.dumps({"key": k}).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=10) as r:
                assert r.status == 204

        def status():
            return json.loads(get("/status")[1])

        png = _poll(lambda: (lambda s, b: b if s == 200 else None)(*get("/frame.png")),
                    "a frame")
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert get("/")[0] == 200 and get("/nothing")[0] == 404
        key("p")
        _poll(lambda: status()["paused"], "pause")
        key("]")
        _poll(lambda: status()["env"] == 1, "the env switch")
        key("f")
        _poll(lambda: status()["mode"] == "fixed", "the mode switch")
        before = wv.viewer.camera_position.copy()
        key("ArrowLeft")
        _poll(lambda: not np.array_equal(wv.viewer.camera_position, before), "the orbit")
        key("q")
        thread.join(timeout=DEADLINE_S)
        assert not thread.is_alive()
    finally:
        wv.quit = True
        thread.join(timeout=DEADLINE_S)


def test_encode_png_is_a_valid_png():
    img = np.random.default_rng(0).integers(0, 255, (5, 7, 3), dtype=np.uint8)
    png = encode_png(img)
    from aerial_gym_simulator_tpu.viewer.web_viewer import encode_png as j_encode_png
    assert png == j_encode_png(img)
    assert png[:8] == b"\x89PNG\r\n\x1a\n"


@pytest.mark.parametrize("main", [live_viewer.main, web_viewer.main],
                         ids=["live_viewer", "web_viewer"])
def test_viewer_commands_run_on_cuda_unless_asked_for_the_cpu(main):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--steps", "1"])
