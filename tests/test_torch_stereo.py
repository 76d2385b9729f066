"""Port parity for stereo capture and multi-sensor mounts: the stereo
camera config and robot, the stereo render against the JAX oracle path,
the right eye's depth-only cast and the multiplier's commutation with the
max, and a robot with two cameras (``num_sensors`` = 2) against the JAX
package with its mounts fed in, each sensor slice against the
single-sensor render, mounts drawn per copy, masked resets and saved
state.

Tolerances: depth pixels atol 2e-3 (normalized by max_range) and seg
agreement > 0.999 on hit pixels against the JAX package (the bar of
tests/test_torch_slice.py); bit equality (torch.equal) within the port.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.config.robot_config import catalog as j_catalog
from aerial_gym_simulator_tpu.config.sensor_config import sensor_configs as j_sc
from aerial_gym_simulator_tpu.registry.registries import robot_registry as j_robot
from aerial_gym_simulator_tpu.sensors import raycast_sensor as j_rs
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.robot_config import catalog as t_catalog
from aerial_gym_simulator_tpu_torch.config.sensor_config import sensor_configs as t_sc
from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
from aerial_gym_simulator_tpu_torch.registry.registries import robot_registry as t_robot
from aerial_gym_simulator_tpu_torch.sensors import raycast_sensor as t_rs
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.sim.structs import replace


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


DEPTH_ATOL = 2e-3
SEG_AGREE = 0.999
N = 4
SMALL = dict(height=24, width=32)
TWIN = "twin_camera_quad_stereo_test"


def _twin(catalog, sensor_configs, S=2, randomize=False):
    def robot_fn():
        cfg = catalog.base_quadrotor()
        cfg.name = TWIN
        cfg.sensor_config.enable_camera = True
        cam = sensor_configs.BaseDepthCameraConfig(**SMALL)
        cam.num_sensors = S
        cam.randomize_placement = randomize
        cfg.sensor_config.camera_config = cam
        return cfg
    return robot_fn


j_robot.register(TWIN, _twin(j_catalog, j_sc))
t_robot.register(TWIN, _twin(t_catalog, t_sc))


def test_stereo_config_and_robot_match_jax():
    t_cfg, j_cfg = t_sc.StereoCameraConfig(), j_sc.StereoCameraConfig()
    assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg)
    assert (t_cfg.height, t_cfg.width, t_cfg.stereo_baseline) == (270, 480, 0.095)
    t_rob = t_robot.make("base_quadrotor_with_stereo_camera")
    j_rob = j_robot.make("base_quadrotor_with_stereo_camera")
    assert t_rob.sensor_config.enable_camera and j_rob.sensor_config.enable_camera
    assert (dataclasses.asdict(t_rob.sensor_config.camera_config)
            == dataclasses.asdict(j_rob.sensor_config.camera_config))


@pytest.fixture(scope="module")
def stereo_envs():
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_stereo_camera",
             "lee_velocity_control")
    jenv = JSimBuilder().build_env(*names, num_envs=N, seed=4)
    tenv = port.SimBuilder().build_env(*names, device="cpu", num_envs=N, seed=4)
    assert tenv.params.camera.stereo_baseline == pytest.approx(0.095)
    assert tenv.params.camera.dirs.shape == (270, 480, 3)
    jenv.params = jenv.params.replace(
        camera=j_rs.build_ray_sensor_params(j_sc.StereoCameraConfig(**SMALL)))
    tenv.params = replace(tenv.params, camera=t_rs.build_ray_sensor_params(
        t_sc.StereoCameraConfig(**SMALL), "cpu"))
    rs = np.random.RandomState(2)
    for _ in range(2):
        jenv.step(rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32))
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=4)
    return jenv, tenv


def _agree(depth_t, seg_t, depth_j, seg_j):
    np.testing.assert_allclose(depth_t, depth_j, atol=DEPTH_ATOL, rtol=0)
    hit = seg_j != -2
    assert hit.any()
    assert (seg_t[hit] == seg_j[hit]).mean() > SEG_AGREE


def test_stereo_render_matches_jax(stereo_envs):
    jenv, tenv = stereo_envs
    js, ts = jenv.state, tenv.state
    d_j, s_j = j_rs.render(jenv.params, js, jenv.params.camera, js.cam_mount_pos,
                           js.cam_mount_quat)
    d_t, s_t = t_rs.render(tenv.params, ts, tenv.params.camera, ts.cam_mount_pos,
                           ts.cam_mount_quat)
    assert d_t.shape == (N, 24, 32) and s_t.shape == (N, 24, 32)
    _agree(d_t.numpy(), s_t.numpy(), np.asarray(d_j), np.asarray(s_j))
    # the second eye changes the image: the baseline is live
    mono = replace(tenv.params.camera, stereo_baseline=0.0)
    d_mono, _ = t_rs.render(tenv.params, ts, mono, ts.cam_mount_pos, ts.cam_mount_quat)
    assert not torch.equal(d_mono, d_t)
    assert (d_t >= d_mono).all()


def test_stereo_right_eye_is_depth_only(stereo_envs, monkeypatch):
    """The left eye keeps its mode (K2 for this segmentation camera), the
    right eye is cast depth-only (K1), from the left eye's origin moved by
    the baseline along the sensor frame's -x."""
    _, tenv = stereo_envs
    calls = []
    real = raycast_cuda.raycast

    def spy(pose, *args, **kw):
        calls.append((pose.clone(), kw.get("want_seg", True)))
        return real(pose, *args, **kw)

    monkeypatch.setattr(raycast_cuda, "raycast", spy)
    ts, sp = tenv.state, tenv.params.camera
    t_rs.render(tenv.params, ts, sp, ts.cam_mount_pos, ts.cam_mount_quat)
    assert [w for _, w in calls] == [True, False]
    (left, _), (right, _) = calls
    assert torch.equal(left[:, 3:], right[:, 3:])
    _, quat_w = t_rs.sensor_world_pose(sp, ts, ts.cam_mount_pos, ts.cam_mount_quat)
    from aerial_gym_simulator_tpu_torch.utils.math import quat_rotate_inverse
    local = quat_rotate_inverse(quat_w, right[:, :3] - left[:, :3])
    torch.testing.assert_close(local, torch.tensor([[-0.095, 0.0, 0.0]]).expand(N, 3),
                               atol=1e-6, rtol=0)


def test_depth_multiplier_commutes_with_the_eyes_max(stereo_envs):
    """The kernel multiplies each eye's range by the (positive) multiplier;
    the JAX package takes the max of the ranges and then multiplies. f32
    rounding is monotonic, so the two orders agree bit for bit."""
    _, tenv = stereo_envs
    ts, sp, sc = tenv.state, tenv.params.camera, tenv.params.scene
    pos_w, quat_w = t_rs.sensor_world_pose(sp, ts, ts.cam_mount_pos, ts.cam_mount_quat)
    prims = raycast_cuda.pack_prims_world(sc, ts.obstacle_pos, ts.obstacle_quat)
    g = torch.Generator().manual_seed(0)
    mult = sp.depth_multiplier * (0.5 + torch.rand(sp.depth_multiplier.shape, generator=g))
    ones = torch.ones_like(mult)
    right = pos_w + torch.tensor([0.3, -0.2, 0.1])
    counts = (sc.n_box, sc.n_cyl, sc.n_sph, 20.0)

    def cast(origin, m):
        return raycast_cuda.raycast(raycast_cuda.pack_pose(origin, quat_w), prims, sp.dirs, m,
                                    *counts, want_seg=False, n_tri=sc.n_tri)[0]

    kernel_order = torch.maximum(cast(pos_w, mult), cast(right, mult))
    jax_order = torch.maximum(cast(pos_w, ones), cast(right, ones)) * mult.reshape(-1)
    assert torch.equal(kernel_order, jax_order)


@pytest.fixture(scope="module")
def twin_envs():
    names = ("base_sim", "env_with_obstacles", TWIN, "lee_velocity_control")
    jenv = JSimBuilder().build_env(*names, num_envs=2, seed=5)
    tenv = port.SimBuilder().build_env(*names, device="cpu", num_envs=2, seed=5)
    jenv.step(jnp.zeros((2, 4)))
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=5)
    return jenv, tenv


def test_twin_camera_stack_matches_jax(twin_envs):
    jenv, tenv = twin_envs
    assert tenv.state.cam_mount_pos.shape == (2, 2, 3)
    assert tenv.state.cam_mount_quat.shape == (2, 2, 4)
    jenv.render()
    frames = tenv.render()
    assert frames.shape == (2, 2, 24, 32)
    j_obs, t_obs = jenv.get_obs(), tenv.get_obs()
    assert t_obs["segmentation_pixels"].shape == (2, 2, 24, 32)
    _agree(t_obs["depth_range_pixels"].numpy(), t_obs["segmentation_pixels"].numpy(),
           np.asarray(j_obs["depth_range_pixels"]), np.asarray(j_obs["segmentation_pixels"]))


def test_twin_camera_slices_equal_the_single_sensor_render(twin_envs):
    _, tenv = twin_envs
    frames = tenv.render().clone()
    ts = tenv.state
    single = replace(tenv.params.camera, num_sensors=1)
    for k in range(2):
        d, _ = t_rs.render(tenv.params, ts, single, ts.cam_mount_pos[:, k],
                           ts.cam_mount_quat[:, k])
        assert torch.equal(frames[:, k], d)


def test_multi_sensor_mounts_drawn_per_copy_and_reset_by_mask(tmp_path):
    t_robot.register(TWIN + "_random", _twin(t_catalog, t_sc, S=3, randomize=True))
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", TWIN + "_random",
                                      "lee_velocity_control", device="cpu", num_envs=5,
                                      seed=6)
    sp, st = env.params.camera, env.state
    pos = st.cam_mount_pos
    assert pos.shape == (5, 3, 3) and st.cam_mount_quat.shape == (5, 3, 4)
    assert ((pos >= sp.min_translation) & (pos <= sp.max_translation)).all()
    assert not torch.equal(pos[:, 0], pos[:, 1]) and not torch.equal(pos[:, 1], pos[:, 2])
    torch.testing.assert_close(st.cam_mount_quat.norm(dim=-1), torch.ones(5, 3))
    before_pos, before_quat = pos.clone(), st.cam_mount_quat.clone()
    env.reset_idx([2])
    after = env.state.cam_mount_pos
    keep = [0, 1, 3, 4]
    assert torch.equal(after[keep], before_pos[keep])
    assert torch.equal(env.state.cam_mount_quat[keep], before_quat[keep])
    assert not torch.equal(after[2], before_pos[2])
    # the (N, S, .) mounts are in the saved state
    env.save_state(str(tmp_path / "sim.pt"))
    env.reset()
    env.load_state(str(tmp_path / "sim.pt"))
    assert torch.equal(env.state.cam_mount_pos, after)


def test_convert_carries_multi_sensor_mounts(twin_envs):
    jenv, _ = twin_envs
    ts = state_from_numpy(record_to_numpy(jenv.state), "cpu")
    np.testing.assert_array_equal(ts.cam_mount_pos.numpy(), np.asarray(jenv.state.cam_mount_pos))
    np.testing.assert_array_equal(ts.cam_mount_quat.numpy(),
                                  np.asarray(jenv.state.cam_mount_quat))
    assert ts.cam_mount_pos.shape == (2, 2, 3)
