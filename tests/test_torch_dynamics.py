"""Port parity: the obstacle env + camera quad's param/scene builders and
20 env steps (10 physics substeps each) against the JAX package, from a
state carried across from the JAX builder.

Tolerances:
  * builders: integer leaves exact; float leaves atol 1e-6 (the same
    numbers reach f32 through different parsers and float64 paths);
  * trajectory: atol 1e-4 on pos/quat/linvel after 200 substeps, 5e-3
    on the fast modes (body rates, motor thrusts). One substep differs by
    rounding only (~1e-7 relative); the closed loop carries that to
    ~1e-5 in pose and up to ~1e-3 in body rate over the 20 steps below.
    Crash flags must agree exactly.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.envs.scene import build_scene_params as j_build_scene
from aerial_gym_simulator_tpu.registry.registries import (
    controller_registry as j_ctrl, env_config_registry as j_env,
    robot_registry as j_robot, sim_config_registry as j_sim)
from aerial_gym_simulator_tpu.sim import dynamics as jd
from aerial_gym_simulator_tpu.sim.params import build_sim_params as j_build_sim_params
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch  # noqa: F401  (registers the port's configs)
from aerial_gym_simulator_tpu_torch.envs.scene import build_scene_params as t_build_scene
from aerial_gym_simulator_tpu_torch.registry.registries import (
    controller_registry as t_ctrl, env_config_registry as t_env,
    robot_registry as t_robot, sim_config_registry as t_sim)
from aerial_gym_simulator_tpu_torch.sim import dynamics as td
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params as t_build_sim_params


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
NAMES = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
         "lee_velocity_control")


def assert_records_match(port, ref, path="", atol=1e-6):
    """Leaf-by-leaf comparison of two nested numpy dicts."""
    if isinstance(ref, dict):
        assert isinstance(port, dict), path
        for k, v in ref.items():
            assert_records_match(port[k], v, f"{path}.{k}", atol)
        return
    if ref is None or isinstance(ref, (bool, str)):
        assert port == ref, path
        return
    p, r = np.asarray(port), np.asarray(ref)
    assert p.shape == r.shape, (path, p.shape, r.shape)
    if r.dtype.kind in "iub":
        np.testing.assert_array_equal(p, r, err_msg=path)
    else:
        np.testing.assert_allclose(p, r, atol=atol, rtol=0, err_msg=path)


@pytest.mark.parametrize("num_envs,seed", [(8, 1234), (37, 1234), (16, 99)])
def test_scene_builder_matches_jax(num_envs, seed):
    j = record_to_numpy(j_build_scene(j_env.make("env_with_obstacles"), num_envs, seed=seed))
    t = record_to_numpy(t_build_scene(t_env.make("env_with_obstacles"), num_envs, "cpu",
                                      seed=seed))
    assert_records_match(t, j)
    # kind-sorted soup: box | cylinder | sphere | triangle columns
    assert t["num_env_prims"] == t["n_box"] + t["n_cyl"] + t["n_sph"] + t["n_tri"]


def test_sim_params_builder_matches_jax():
    jp = j_build_sim_params(*(r.make(n) for r, n in zip((j_sim, j_env, j_robot, j_ctrl), NAMES)),
                            num_envs=N)
    tp = t_build_sim_params(*(r.make(n) for r, n in zip((t_sim, t_env, t_robot, t_ctrl), NAMES)),
                            "cpu", num_envs=N)
    assert_records_match(record_to_numpy(tp), record_to_numpy(jp))


def test_lmf2_sim_params_builder_matches_jax():
    """The navigation task's platform: lmf2 (root-link wrench, random
    wrench disturbance, depth camera) with its own velocity-controller
    gains, dispatched to lee_velocity_control."""
    names = ("base_sim", "env_with_obstacles", "lmf2", "lmf2_velocity_control")
    jp = j_build_sim_params(*(r.make(n) for r, n in zip((j_sim, j_env, j_robot, j_ctrl), names)),
                            num_envs=N)
    tp = t_build_sim_params(*(r.make(n) for r, n in zip((t_sim, t_env, t_robot, t_ctrl), names)),
                            "cpu", num_envs=N)
    assert_records_match(record_to_numpy(tp), record_to_numpy(jp))
    assert tp.controller.name == "lee_velocity_control" and tp.controller.randomize_params
    assert tp.robot.enable_disturbance and tp.robot.force_application_level == "root_link"
    assert float(tp.controller.K_vel_min[2]) > float(tp.controller.K_vel_max[2])


def test_params_round_trip_through_numpy():
    jp = j_build_sim_params(*(r.make(n) for r, n in zip((j_sim, j_env, j_robot, j_ctrl), NAMES)),
                            num_envs=N)
    d = record_to_numpy(jp)
    tp = params_from_numpy(d, "cpu")
    assert_records_match(record_to_numpy(tp), d)


@pytest.fixture(scope="module")
def carried():
    env = JSimBuilder().build_env(*NAMES, num_envs=N, seed=5)
    tp = params_from_numpy(record_to_numpy(env.params), "cpu")
    ts = state_from_numpy(record_to_numpy(env.state), "cpu", seed=5)
    return env.params, env.state, tp, ts


def _compare_states(ts, js, atol, fields=("pos", "quat", "linvel", "obstacle_pos")):
    for f in fields:
        np.testing.assert_allclose(getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                                   atol=atol, rtol=0, err_msg=f)
    np.testing.assert_array_equal(ts.crashes.numpy(), np.asarray(js.crashes))
    np.testing.assert_array_equal(ts.sim_steps.numpy(), np.asarray(js.sim_steps))


def test_twenty_env_steps_match_jax(carried):
    jp, js, tp, ts = carried
    rs = np.random.RandomState(0)
    # velocity commands of a cruising quad (|v| <= 0.5 m/s per axis): the
    # closed loop amplifies rounding differences with the angular rates it
    # reaches, ~3e-5 after 20 steps here against ~1e-3 at 2 m/s commands
    actions = rs.uniform(-0.5, 0.5, (20, N, 4)).astype(np.float32)
    step = jax.jit(lambda s, a: jd.env_step(jp, s, a))
    crashed = np.zeros(N, bool)
    for a in actions:
        js = step(js, jnp.asarray(a))
        ts = td.env_step(tp, ts, torch.from_numpy(a))
        crashed |= np.asarray(js.crashes) > 0
    _compare_states(ts, js, atol=1e-4)
    # body rates and motor thrusts are the fastest modes (inertia ~1e-3
    # kg m^2, 40 ms motor lag): their share of the same rounding drift
    # reaches ~1e-3 in one env here while pose and velocity stay < 1e-4
    _compare_states(ts, js, atol=5e-3, fields=("angvel", "motor_thrust"))
    assert crashed.any()        # the crash path was exercised (seed 5: env 6)
    assert np.isfinite(ts.pos.numpy()).all()


def test_contact_forces_match_jax(carried):
    """Collision proxy on robots placed on and around obstacle surfaces."""
    from aerial_gym_simulator_tpu.envs.collision import scene_sdf_point as j_sdf
    from aerial_gym_simulator_tpu_torch.envs.collision import scene_sdf_point as t_sdf
    jp, js, tp, ts = carried
    rs = np.random.RandomState(4)
    # points near each env's first few obstacles
    centers = np.asarray(js.obstacle_pos)[:, :8].reshape(-1, 3)
    pts = (centers + rs.normal(scale=0.4, size=centers.shape)).astype(np.float32)
    for k in range(0, len(pts), N):
        p = pts[k:k + N]
        d_j = np.asarray(j_sdf(jp, js, jnp.asarray(p)))
        d_t = t_sdf(tp, ts, torch.from_numpy(p)).numpy()
        np.testing.assert_allclose(d_t, d_j, atol=1e-5)


def test_reset_draws_stay_in_configured_ranges(carried):
    """Resets draw from the port's own generator, so values differ from
    JAX; they must respect the same ranges and masks."""
    jp, js, tp, ts = carried
    mask = torch.tensor([1.0, 0.0] * (N // 2))
    out = td.reset_envs(tp, ts, mask)
    keep = mask == 0
    assert torch.equal(out.pos[keep], ts.pos[keep])
    lo, hi = tp.env.lower_bound_min, tp.env.lower_bound_max
    assert ((out.bounds_lo >= lo) & (out.bounds_lo <= hi)).all()
    assert torch.allclose(out.quat.norm(dim=-1), torch.ones(N), atol=1e-6)
    assert (out.obstacle_pos[mask > 0][..., 0] >= -1000.0).all()
    assert ((out.cam_mount_pos[mask > 0] >= tp.camera.min_translation)
            & (out.cam_mount_pos[mask > 0] <= tp.camera.max_translation)).all()
    assert (out.sim_steps[mask > 0] == 0).all()
    assert dataclasses.is_dataclass(out)
