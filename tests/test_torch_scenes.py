"""Port parity for the forest and dynamic-obstacle scenes: the tree URDF,
the new asset types and env configs, the compiled scene tables (procedural
variants and an on-disk asset folder), the env actions that set the
obstacles' twists, and dynamic_env steps from a carried-across state.

Tolerances:
  * tree URDF text: equal, byte for byte;
  * configs: every field of the port's equal (float lists to 1e-12);
  * scene tables: integer leaves exact, float leaves 1e-6;
  * apply_env_actions: exact (a copy of the inputs);
  * five dynamic_env steps from a carried-across state: pose and linear
    velocity 1e-4, obstacle poses 1e-5 (the bars of
    tests/test_torch_dynamics.py);
  * obstacle travel against steps x substeps x dt x v: 1e-4 m (f32
    rounding of 30 additions to positions of up to ~10 m).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.assets import procedural as j_proc
from aerial_gym_simulator_tpu.config.asset_config import env_object_config as j_eoc
from aerial_gym_simulator_tpu.config.env_config import obstacle_envs as j_envs
from aerial_gym_simulator_tpu.envs import scene as j_scene
from aerial_gym_simulator_tpu.registry.registries import env_config_registry as j_env_reg
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.assets import procedural as t_proc
from aerial_gym_simulator_tpu_torch.config.asset_config import env_object_config as t_eoc
from aerial_gym_simulator_tpu_torch.config.env_config import obstacle_envs as t_envs
from aerial_gym_simulator_tpu_torch.envs import scene as t_scene
from aerial_gym_simulator_tpu_torch.registry.registries import env_config_registry as t_env_reg
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


N = 8
ASSET_PARAMS = ("thin_asset_params", "tile_asset_params", "tree_asset_params",
                "dynamic_object_asset_params")


def _leaves_match(port_rec, ref_rec, path="", atol=1e-6):
    if isinstance(ref_rec, dict):
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}", atol)
    elif ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
    else:
        ref = np.asarray(ref_rec)
        got = np.asarray(port_rec)
        assert got.shape == ref.shape, path
        if ref.dtype.kind in "iub":
            np.testing.assert_array_equal(got, ref, err_msg=path)
        else:
            np.testing.assert_allclose(got.astype(np.float64), ref.astype(np.float64),
                                       atol=atol, err_msg=path)


def _same_config(t_cfg, j_cfg):
    """Every field of the port's config equals the JAX config's (the port's
    env configs leave out the JAX base's fields that nothing reads)."""
    td, jd = dataclasses.asdict(t_cfg), dataclasses.asdict(j_cfg)
    assert set(td) <= set(jd), set(td) - set(jd)
    for k in td:
        v = jd[k]
        if isinstance(v, float) or (isinstance(v, (list, tuple)) and v
                                    and isinstance(v[0], float)):
            np.testing.assert_allclose(np.asarray(td[k], np.float64),
                                       np.asarray(v, np.float64), atol=1e-12, err_msg=k)
        else:
            assert td[k] == v, k


@pytest.mark.parametrize("i", range(8))
def test_tree_urdf_text_equal(i):
    kw = dict(trunk_radius=0.05 + 0.02 * (i % 4), trunk_height=2.0 + 0.5 * (i % 3),
              crown_radius=0.5 + 0.15 * (i % 3), seed=i)
    assert t_proc.tree_urdf(f"tree_{i}", **kw) == j_proc.tree_urdf(f"tree_{i}", **kw)


@pytest.mark.parametrize("name", ASSET_PARAMS)
def test_asset_params_equal(name):
    _same_config(getattr(t_eoc, name)(), getattr(j_eoc, name)())


@pytest.mark.parametrize("name", ["forest_env", "dynamic_env"])
def test_env_configs_equal_and_registered(name):
    t_cfg, j_cfg = t_env_reg.make(name), j_env_reg.make(name)
    _same_config(t_cfg, j_cfg)
    assert t_cfg.num_env_actions == {"forest_env": 4, "dynamic_env": 6}[name]
    assert isinstance(t_cfg, t_envs.ObstacleEnvConfig)


def test_forest_scene_tables_equal():
    cfg_t, cfg_j = t_envs.ForestEnvConfig(), j_envs.ForestEnvConfig()
    t_sc = t_scene.build_scene_params(cfg_t, N, "cpu")
    j_sc = j_scene.build_scene_params(cfg_j, N)
    _leaves_match(record_to_numpy(t_sc), record_to_numpy(j_sc))
    # a tree is a cylinder, a sphere and three boxes
    assert t_sc.n_cyl >= 1 and t_sc.n_sph == 1


def test_forest_scene_tables_equal_with_the_python_parser(monkeypatch):
    """AERIAL_GYM_TPU_NATIVE_LOADER=0 takes each package's Python parser:
    the tables still agree with the native compiler's to f32 rounding."""
    native = t_scene.build_scene_params(t_envs.ForestEnvConfig(), N, "cpu")
    monkeypatch.setenv("AERIAL_GYM_TPU_NATIVE_LOADER", "0")
    t_sc = t_scene.build_scene_params(t_envs.ForestEnvConfig(), N, "cpu")
    j_sc = j_scene.build_scene_params(j_envs.ForestEnvConfig(), N)
    _leaves_match(record_to_numpy(t_sc), record_to_numpy(j_sc))
    _leaves_match(record_to_numpy(t_sc), record_to_numpy(native))


def test_asset_folder_tables_equal(tmp_path):
    """An asset type's folder: every *.urdf, sorted, is a variant, compiled
    by the native batch loader in both packages."""
    for i in range(3):
        (tmp_path / f"tree_{i}.urdf").write_text(j_proc.tree_urdf(f"t{i}", seed=i))
    (tmp_path / "pole.urdf").write_text(j_proc.cylinder_urdf("pole", 0.1, 2.0))
    (tmp_path / "notes.txt").write_text("not a urdf")

    def cfg(eoc, envs):
        at = eoc.AssetTypeConfig(name="folder", num_assets=4, urdf_variants=[],
                                 asset_folder=str(tmp_path),
                                 min_state_ratio=eoc._ratio(0.2, 0.2, 0.0),
                                 max_state_ratio=eoc._ratio(0.8, 0.8, 0.0),
                                 keep_in_env=True)
        c = envs.ForestEnvConfig()
        c.asset_types = [at, eoc.bottom_wall()]
        c.__post_init__()
        return c

    t_sc = t_scene.build_scene_params(cfg(t_eoc, t_envs), N, "cpu")
    j_sc = j_scene.build_scene_params(cfg(j_eoc, j_envs), N)
    _leaves_match(record_to_numpy(t_sc), record_to_numpy(j_sc))
    assert t_sc.prim_kind.shape[0] == 5          # 4 files + the wall


@pytest.fixture(scope="module")
def dynamic_envs():
    names = ("base_sim", "dynamic_env", "base_quadrotor", "lee_velocity_control")
    jenv = JSimBuilder().build_env(*names, num_envs=N, seed=3)
    tenv = port.SimBuilder().build_env(*names, device="cpu", num_envs=N, seed=3)
    _leaves_match(record_to_numpy(tenv.params), record_to_numpy(jenv.params))
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=3)
    return jenv, tenv


def _twists(A, width, seed):
    rs = np.random.RandomState(seed)
    return (rs.uniform(-0.5, 0.5, (N, width)).astype(np.float32),
            rs.uniform(-0.5, 0.5, (N, A, width)).astype(np.float32))


@pytest.mark.parametrize("width", [6, 4])
@pytest.mark.parametrize("per_slot", [False, True], ids=["broadcast", "per_slot"])
def test_apply_env_actions_matches_jax(dynamic_envs, width, per_slot):
    jenv, tenv = dynamic_envs
    A = tenv.params.scene.num_assets
    a = _twists(A, width, seed=width)[int(per_slot)]
    js = j_scene.apply_env_actions(jenv.params, jenv.state, jnp.asarray(a))
    ts = t_scene.apply_env_actions(tenv.params, tenv.state, torch.from_numpy(a))
    for f in ("obstacle_linvel", "obstacle_angvel"):
        got, want = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert got.shape == (N, A, 3)
        np.testing.assert_array_equal(got, want, err_msg=f)
    if width < 6:
        assert not ts.obstacle_angvel.any()


def test_dynamic_env_steps_match_jax(dynamic_envs):
    jenv, tenv = dynamic_envs
    A = tenv.params.scene.num_assets
    rs = np.random.RandomState(11)
    twist = rs.uniform(-0.3, 0.3, (N, A, 6)).astype(np.float32)
    for k in range(5):
        a = rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32)
        ea = twist if k % 2 == 0 else None          # twists persist between env actions
        jenv.step(a, env_actions=None if ea is None else jnp.asarray(ea))
        tenv.step(torch.from_numpy(a), env_actions=None if ea is None else torch.from_numpy(ea))
    for f, tol in (("pos", 1e-4), ("quat", 1e-4), ("linvel", 1e-4),
                   ("obstacle_pos", 1e-5), ("obstacle_quat", 1e-5),
                   ("obstacle_linvel", 0.0), ("obstacle_angvel", 0.0)):
        np.testing.assert_allclose(getattr(tenv.state, f).numpy(),
                                   np.asarray(getattr(jenv.state, f)), atol=tol, err_msg=f)
    assert torch.equal(tenv.env_actions, torch.from_numpy(twist))


def test_obstacles_move_by_twist_and_reset_zeroes_it(tmp_path):
    env = port.SimBuilder().build_env("base_sim", "dynamic_env", "base_quadrotor",
                                      "lee_velocity_control", device="cpu", num_envs=4, seed=1)
    A, p = env.params.scene.num_assets, env.params
    v = torch.tensor([0.1, 0.05, 0.0, 0.0, 0.0, 0.2])
    p0 = env.state.obstacle_pos.clone()
    steps = 3
    env.step(torch.zeros(4, 4), env_actions=v.expand(4, 6))
    for _ in range(steps - 1):
        env.step(torch.zeros(4, 4))
    moved = env.state.obstacle_pos - p0
    want = steps * p.env.substep_mean * p.dt * v[:3]
    # 30 f32 additions to positions up to ~10 m: ~1e-5 of rounding
    torch.testing.assert_close(moved, want.expand(4, A, 3), atol=1e-4, rtol=0)
    # the twist is in the saved state: a reload continues the same motion
    env.save_state(str(tmp_path / "sim.pt"))
    env.step(torch.zeros(4, 4))
    after = env.state.obstacle_pos.clone()
    env.load_state(str(tmp_path / "sim.pt"))
    assert torch.equal(env.state.obstacle_angvel[:, :, 2], torch.full((4, A), 0.2))
    env.step(torch.zeros(4, 4))
    assert torch.equal(env.state.obstacle_pos, after)
    env.reset_idx([1])
    assert not env.state.obstacle_linvel[1].any()
    assert env.state.obstacle_linvel[0].abs().sum() > 0


def test_forest_env_builds_and_renders_through_simbuilder():
    env = port.SimBuilder().build_env("base_sim", "forest_env", "base_quadrotor_with_camera",
                                      "lee_velocity_control", device="cpu", num_envs=2, seed=0)
    from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
        BaseDepthCameraConfig)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    env.params = replace(env.params, camera=build_ray_sensor_params(
        BaseDepthCameraConfig(height=12, width=16), "cpu"))
    env.reset()
    env.step(torch.zeros(2, 4), env_actions=torch.full((2, 4), 0.1))
    assert not env.state.obstacle_angvel.any()
    frames = env.render()
    assert frames.shape == (2, 12, 16) and torch.isfinite(frames).all()
    assert env.env_config.name == "forest_env"
