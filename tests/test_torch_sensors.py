"""Port parity for the sensor captures of the normal/face-id and RGB slice:
the lidar ray table and config, the two robots' sensor params, and
render_normal_faceid_camera, render_rgb_camera, render_normal_faceid_lidar
and render_lidar (noise off) from a state carried across from the JAX
package (sim/convert.py), against the JAX package's functions; then the
port's own plumbing: stacked mounts, the empty scene, mount sampling at
reset and EnvManager.render's keys; and every config of the sensor catalog
with its ray table.

Tolerances, as in tests/test_torch_raycast_normals.py: depth atol 2e-3 (the
lidar image is normalized by its max range, so 2e-3 of it); face and seg
agree on more than 99.5% of the rays, normals atol 5e-3 and rgb atol 5e-3
where they do, misses exact, sky 1e-6; ray tables within 1e-6.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.config.sensor_config import sensor_configs as j_cfgs
from aerial_gym_simulator_tpu.registry import registries as j_reg
from aerial_gym_simulator_tpu.sensors import raycast_sensor as j_rs
from aerial_gym_simulator_tpu.sim.params import build_sim_params as j_build_sim_params
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config import sensor_configs as t_cfgs
from aerial_gym_simulator_tpu_torch.registry import registries as t_reg
from aerial_gym_simulator_tpu_torch.sensors import raycast_sensor as t_rs
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params as t_build_sim_params
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


N = 3
CAM = dict(height=12, width=32, max_range=4.0)       # 4 m leaves hits and misses
LIDAR = dict(height=8, width=64, max_range=4.0)
FACE_AGREE = 0.995


def _noise_off(cfgs):
    return cfgs.SensorNoiseConfig(enable_sensor_noise=False)


def _leaves_match(port_rec, ref_rec, path=""):
    if isinstance(ref_rec, dict):
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}")
    elif ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
    else:
        np.testing.assert_allclose(np.asarray(port_rec, np.float64),
                                   np.asarray(ref_rec, np.float64), atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def captured():
    """A JAX env with the normal/face-id camera and a lidar (small tables),
    the port's copy of its params and state, and the JAX captures."""
    jenv = JSimBuilder().build_env("base_sim", "env_with_obstacles",
                                   "base_quadrotor_with_faceid_normal_camera",
                                   "lee_velocity_control", num_envs=N, seed=5)
    jp = jenv.params.replace(
        camera=j_rs.build_ray_sensor_params(j_cfgs.BaseNormalFaceIDCameraConfig(**CAM)),
        lidar=j_rs.build_ray_sensor_params(j_cfgs.BaseLidarConfig(
            **LIDAR, sensor_noise=_noise_off(j_cfgs))))
    # a lidar mount of its own: 5 cm above the camera's, yawed by 30 degrees
    q = np.array([0.0, 0.0, np.sin(np.pi / 12), np.cos(np.pi / 12)], np.float32)
    js = jenv.state.replace(lidar_mount_pos=jenv.state.cam_mount_pos + jnp.array([0, 0, 0.05]),
                            lidar_mount_quat=jnp.broadcast_to(jnp.asarray(q), (N, 4)))
    j_out = jax.jit(lambda s: (j_rs.render_normal_faceid_camera(jp, s),
                               j_rs.render_rgb_camera(jp, s),
                               j_rs.render_normal_faceid_lidar(jp, s),
                               j_rs.render_lidar(jp, s)))(js)
    j_out = jax.tree_util.tree_map(np.asarray, j_out)
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu", seed=5)
    return dict(jp=jp, js=js, tp=tp, ts=ts, j_normals_cam=j_out[0], j_rgb=j_out[1],
                j_normals_lidar=j_out[2], j_lidar=j_out[3])


def _assert_normals_match(got, want):
    depth, normal, face, seg = (x.numpy() for x in got)
    d_ref, n_ref, f_ref, s_ref = want
    assert depth.shape == d_ref.shape and normal.shape == n_ref.shape
    np.testing.assert_allclose(depth, d_ref, atol=2e-3, rtol=0)
    hit = f_ref >= 0
    assert hit.any() and (~hit).any()
    same = face == f_ref
    assert same.mean() > FACE_AGREE
    assert (seg[hit & same] == s_ref[hit & same]).all()
    assert (face[~hit] == -1).all() and (seg[~hit] == -2).all()
    assert (normal[~hit] == 0.0).all() and (depth[~hit] == 1000.0).all()
    np.testing.assert_allclose(normal[hit & same], n_ref[hit & same], atol=5e-3, rtol=0)


# ---------------------------------------------------------------------------
# tables, configs, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", [(128, 512, -180.0, 180.0, -45.0, 45.0),
                                   (48, 120, -180.0, 180.0, -22.5, 22.5),
                                   (16, 90, -60.0, 60.0, -10.0, 30.0), (1, 1, -5, 5, 0, 0)])
def test_lidar_ray_dirs_match_jax(table):
    dirs, mult = t_rs.lidar_ray_dirs(*table)
    j_dirs, j_mult = j_rs.lidar_ray_dirs(*table)
    assert dirs.dtype == np.float32 and dirs.shape == tuple(table[:2]) + (3,)
    np.testing.assert_allclose(dirs, np.asarray(j_dirs), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(mult, np.asarray(j_mult))


@pytest.mark.parametrize("kwargs", [{}, dict(normalize_range=False), dict(max_range=20.0),
                                    dict(max_range=20.0, far_out_of_range_value=35.0)])
def test_lidar_config_sentinels_match_jax(kwargs):
    t, j = t_cfgs.BaseLidarConfig(**kwargs), j_cfgs.BaseLidarConfig(**kwargs)
    assert t.far_out_of_range_value == j.far_out_of_range_value
    assert t.near_out_of_range_value == j.near_out_of_range_value
    for name in ("height", "width", "max_range", "min_range", "calculate_depth",
                 "segmentation_camera", "normalize_range", "randomize_placement"):
        assert getattr(t, name) == getattr(j, name), name
    assert t.sensor_noise == t_cfgs.SensorNoiseConfig(**vars(j.sensor_noise))


@pytest.mark.parametrize("robot", ["base_quadrotor_with_faceid_normal_camera",
                                   "base_quadrotor_with_lidar"])
def test_robot_params_match_jax(robot):
    """The two robots' SimParams, sensors included, leaf for leaf."""
    names = ("base_sim", "empty_env", robot, "lee_velocity_control")
    regs = lambda r: (r.sim_config_registry, r.env_config_registry, r.robot_registry,
                      r.controller_registry)
    j_cfg = [reg.make(n) for reg, n in zip(regs(j_reg), names)]
    t_cfg = [reg.make(n) for reg, n in zip(regs(t_reg), names)]
    jp = j_build_sim_params(*j_cfg, num_envs=2)
    tp = t_build_sim_params(*t_cfg, "cpu", num_envs=2)
    assert (tp.camera is None) == (robot == "base_quadrotor_with_lidar")
    assert (tp.lidar is None) == (robot != "base_quadrotor_with_lidar")
    ref = record_to_numpy(jp)
    ref["imu"] = None
    _leaves_match(record_to_numpy(tp), {k: v for k, v in ref.items() if k in
                                        ("camera", "lidar", "robot", "motor", "env")})


@pytest.mark.parametrize("robot,controller", [("magpie", "magpie_acceleration_control"),
                                              ("lmf2_radar", "lmf2_acceleration_control")])
def test_pointcloud_robot_params_match_jax(robot, controller):
    """magpie (the dome lidar) and lmf2_radar (the radar cone), with their
    acceleration controllers, leaf for leaf."""
    names = ("base_sim", "env_with_lidar_nav_obstacles", robot, controller)
    regs = lambda r: (r.sim_config_registry, r.env_config_registry, r.robot_registry,
                      r.controller_registry)
    jp = j_build_sim_params(*[reg.make(n) for reg, n in zip(regs(j_reg), names)], num_envs=2)
    tp = t_build_sim_params(*[reg.make(n) for reg, n in zip(regs(t_reg), names)], "cpu",
                            num_envs=2)
    assert tp.camera is None and tp.lidar.return_pointcloud and tp.lidar.height == 48
    assert tp.controller.name == "lee_acceleration_control"
    ref = record_to_numpy(jp)
    _leaves_match(record_to_numpy(tp), {k: v for k, v in ref.items() if k in
                                        ("lidar", "robot", "motor", "env", "controller")})


@pytest.mark.parametrize("cfg_name", ["RSLidarAiryConfig", "FakeRadarConfig"])
def test_pointcloud_configs_match_jax(cfg_name):
    t, j = getattr(t_cfgs, cfg_name)(), getattr(j_cfgs, cfg_name)()
    for f in ("height", "width", "horizontal_fov_deg_min", "horizontal_fov_deg_max",
              "vertical_fov_deg_min", "vertical_fov_deg_max", "max_range", "min_range",
              "return_pointcloud", "pointcloud_in_world_frame", "segmentation_camera",
              "normalize_range", "randomize_placement", "min_translation", "max_translation",
              "min_euler_rotation_deg", "max_euler_rotation_deg", "far_out_of_range_value",
              "near_out_of_range_value"):
        assert getattr(t, f) == getattr(j, f), f
    assert t.sensor_noise == t_cfgs.SensorNoiseConfig(**vars(j.sensor_noise))


CATALOG = ("NavDepthCameraConfig", "RsD455Config", "IntelRealSenseD455Config",
           "TofCameraConfig", "LuxonisOakDConfig", "LuxonisOakDProWConfig", "LidarNavConfig",
           "OS0_64Config", "OS0_128Config", "OS1_64Config", "OS2_64Config", "OS2_128Config",
           "PmdFlexx2Config", "StVL53L5CXConfig", "OSDome_64Config", "Lidar2DConfig")


@pytest.mark.parametrize("cfg_name", CATALOG)
def test_sensor_catalog_matches_jax(cfg_name):
    """Every catalog config: its fields (the inherited stale sentinels of
    OS1-64, OS2-64 and the dome kept), and its built params with the ray
    table (dirs, depth multiplier, sentinels) leaf for leaf."""
    t, j = getattr(t_cfgs, cfg_name)(), getattr(j_cfgs, cfg_name)()
    for f in dataclasses.fields(j):
        want = getattr(j, f.name)
        got = getattr(t, f.name)
        if dataclasses.is_dataclass(want):
            want, got = vars(want), vars(got)
        assert got == want, f.name
    assert (t.far_out_of_range_value, t.near_out_of_range_value) == \
        (j.far_out_of_range_value, j.near_out_of_range_value)
    tp = t_rs.build_ray_sensor_params(t, "cpu")
    jp = j_rs.build_ray_sensor_params(j)
    assert tp.dirs.shape == (t.height, t.width, 3)
    _leaves_match(record_to_numpy(tp), record_to_numpy(jp))


@pytest.mark.parametrize("world", [True, False], ids=["world-frame", "sensor-frame"])
def test_pointcloud_capture_matches_jax(world):
    """The dome lidar's pointcloud (a 12x40 table; 4 m range in the sensor
    frame, so that range limits apply) from a state carried across: hits
    within 2e-3 where both sides hit, more than 99.5% of the rays agreeing
    on hit or miss, misses at the no-hit range along the ray (world frame)
    or at the out-of-range sentinels (sensor frame)."""
    kw = dict(height=12, width=40)
    if not world:
        kw.update(pointcloud_in_world_frame=False, max_range=4.0)
    jenv = JSimBuilder().build_env("base_sim", "env_with_lidar_nav_obstacles", "magpie",
                                   "magpie_acceleration_control", num_envs=N, seed=8)
    jp = jenv.params.replace(lidar=j_rs.build_ray_sensor_params(j_cfgs.RSLidarAiryConfig(**kw)))
    pts_ref = np.asarray(jax.jit(lambda s: j_rs.render_lidar(jp, s)[0])(jenv.state))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=8)
    pts, seg = t_rs.render_lidar(tp, ts)
    assert pts.shape == (N, 12, 40, 3) and seg is None
    pts = pts.numpy()
    if world:
        origin = np.asarray(t_rs.sensor_world_pose(tp.lidar, ts, ts.lidar_mount_pos,
                                                   ts.lidar_mount_quat)[0])[:, None, None]
        r, r_ref = (np.linalg.norm(p - origin, axis=-1) for p in (pts, pts_ref))
        hit, hit_ref = r < 10.0, r_ref < 10.0
        miss = ~hit & ~hit_ref
        np.testing.assert_allclose(r[miss], 1000.0, rtol=1e-5)
    else:
        sentinel = lambda p: (p == 10.0).all(-1) | (p == -10.0).all(-1)
        hit, hit_ref = ~sentinel(pts), ~sentinel(pts_ref)
        miss = ~hit & ~hit_ref
        np.testing.assert_array_equal(pts[miss], pts_ref[miss])
        assert (pts[miss] == 10.0).any()                    # the far sentinel, all three
    assert hit_ref.any() and (~hit_ref).any()
    assert (hit == hit_ref).mean() > FACE_AGREE
    both = hit & hit_ref
    np.testing.assert_allclose(pts[both], pts_ref[both], atol=2e-3, rtol=0)


def test_params_carry_across_with_lidar(captured):
    _leaves_match(record_to_numpy(captured["tp"].lidar), record_to_numpy(captured["jp"].lidar))
    assert captured["tp"].lidar.sensor_type == "lidar"


# ---------------------------------------------------------------------------
# captures from a carried-across state
# ---------------------------------------------------------------------------


def test_normal_faceid_camera_matches_jax(captured):
    _assert_normals_match(t_rs.render_normal_faceid_camera(captured["tp"], captured["ts"]),
                          captured["j_normals_cam"])


def test_normal_faceid_lidar_matches_jax(captured):
    got = t_rs.render_normal_faceid_lidar(captured["tp"], captured["ts"])
    assert got[0].shape == (N, LIDAR["height"], LIDAR["width"])
    _assert_normals_match(got, captured["j_normals_lidar"])


def test_rgb_camera_matches_jax(captured):
    rgb, depth, seg = (x.numpy() for x in t_rs.render_rgb_camera(captured["tp"], captured["ts"]))
    rgb_ref, d_ref, s_ref = captured["j_rgb"]
    assert rgb.shape == (N, CAM["height"], CAM["width"], 3)
    hit = s_ref != -2
    assert hit.any() and (~hit).any()
    np.testing.assert_allclose(depth, d_ref, atol=2e-3, rtol=0)
    assert (depth[~hit] == 1000.0).all() and (seg[~hit] == -2).all()
    np.testing.assert_allclose(rgb[~hit], rgb_ref[~hit], atol=1e-6, rtol=0)
    same = seg == s_ref
    assert same.mean() > FACE_AGREE
    np.testing.assert_allclose(rgb[hit & same], rgb_ref[hit & same], atol=5e-3, rtol=0)
    assert rgb.min() >= 0.0 and rgb.max() <= 1.0


def test_render_lidar_matches_jax(captured):
    pixels, seg = t_rs.render_lidar(captured["tp"], captured["ts"])
    px_ref, s_ref = captured["j_lidar"]
    np.testing.assert_allclose(pixels.numpy(), px_ref, atol=2e-3, rtol=0)
    hit = s_ref != -2
    assert hit.any()
    assert (seg.numpy()[hit] == s_ref[hit]).mean() > FACE_AGREE


# ---------------------------------------------------------------------------
# the port's plumbing
# ---------------------------------------------------------------------------


def test_captures_stack_mounts(captured):
    """Mounts (N, S, 3)/(N, S, 4): every output gains the sensor axis at 1
    and each slice is the single-mount capture."""
    tp, ts = captured["tp"], captured["ts"]
    sp = tp.camera
    m0 = ts.cam_mount_pos
    m1 = m0 + torch.tensor([0.0, 0.0, 0.1])
    mq = ts.cam_mount_quat
    mpos, mquat = torch.stack([m0, m1], dim=1), torch.stack([mq, mq], dim=1)
    d, n, f, s = t_rs.render_normal_faceid(tp, ts, sp, mpos, mquat)
    assert d.shape == (N, 2, sp.height, sp.width) and n.shape == (N, 2, sp.height, sp.width, 3)
    single = t_rs.render_normal_faceid(tp, ts, sp, m1, mq)
    for a, b in zip((d, n, f, s), single):
        assert torch.equal(a[:, 1], b)
    rgb, dep, seg = t_rs.render_rgb(tp, ts, sp, mpos, mquat)
    assert rgb.shape == (N, 2, sp.height, sp.width, 3)
    assert torch.equal(rgb[:, 0], t_rs.render_rgb(tp, ts, sp, m0, mq)[0])


def test_empty_scene_captures_sentinels(captured):
    tp, ts = replace(captured["tp"], scene=None), captured["ts"]
    d, n, f, s = t_rs.render_normal_faceid_lidar(tp, ts)
    assert (d == 1000.0).all() and (n == 0.0).all() and (f == -1).all() and (s == -2).all()
    rgb, _, _ = t_rs.render_rgb_camera(tp, ts)
    assert torch.equal(rgb, torch.as_tensor(t_rs.raycast.SKY_RGB).expand_as(rgb))


def test_reset_samples_the_lidar_mount():
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_lidar",
                                      "lee_velocity_control", device="cpu", num_envs=64, seed=1)
    sp, st = env.params.lidar, env.state
    assert env.params.camera is None and sp.height * sp.width == 128 * 512
    assert ((st.lidar_mount_pos >= sp.min_translation) & (st.lidar_mount_pos <= sp.max_translation)).all()
    assert st.lidar_mount_pos.std(dim=0).min() > 0.0            # drawn per env
    torch.testing.assert_close(st.lidar_mount_quat.norm(dim=-1), torch.ones(64))


def _small_env(robot, **sensors):
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", robot,
                                      "lee_velocity_control", device="cpu", num_envs=2, seed=0)
    env.params = replace(env.params, **{k: t_rs.build_ray_sensor_params(v, "cpu")
                                        for k, v in sensors.items()})
    env.reset()
    return env


def test_env_manager_render_keys(caplog):
    """render('rgb') fills rgb_pixels and a plain render() drops it; a camera
    + lidar robot puts the lidar on its own keys; a lidar-only robot keeps the
    camera's keys and warns on render('rgb')."""
    cam = t_cfgs.BaseNormalFaceIDCameraConfig(**CAM)
    lidar = t_cfgs.BaseLidarConfig(**LIDAR)
    env = _small_env("base_quadrotor_with_faceid_normal_camera", camera=cam)
    obs = env.get_obs()
    assert "depth_range_pixels" not in obs and "rgb_pixels" not in obs
    env.render("rgb")
    rgb = env.get_obs()["rgb_pixels"]
    assert rgb.shape == (2, CAM["height"], CAM["width"], 3)
    assert torch.isfinite(rgb).all() and rgb.min() >= 0.0 and rgb.max() <= 1.0
    env.render()
    obs = env.get_obs()
    assert "rgb_pixels" not in obs and obs["depth_range_pixels"].shape == (2, 12, 32)

    env = _small_env("base_quadrotor_with_faceid_normal_camera", camera=cam, lidar=lidar)
    env.render()
    obs = env.get_obs()
    assert obs["depth_range_pixels"].shape == (2, 12, 32)
    assert obs["lidar_range_pixels"].shape == (2, 8, 64)
    assert obs["lidar_segmentation_pixels"].shape == (2, 8, 64)

    env = _small_env("base_quadrotor_with_lidar", lidar=lidar)
    with caplog.at_level(logging.WARNING):
        env.render("rgb")
    assert "no camera" in caplog.text
    obs = env.get_obs()
    assert obs["depth_range_pixels"].shape == (2, 8, 64) and "rgb_pixels" not in obs
    assert "lidar_range_pixels" not in obs
