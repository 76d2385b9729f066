"""Port parity for the IMU (sensors/imu.py): its parameters from the three
IMU configs, one measurement from a state carried across from the JAX
package with JAX's own four normal draws passed in (world frame, gravity
compensation, the noise and bias gates, a perturbed mount), and by
statistics the bias random walk's growth, the reset draws' ranges and the
hover's specific force.

Tolerances: built parameters 1e-6 (float leaves), flags exact; the
measurement 2e-5 on the accelerometer (readings of ~10 m/s^2 through two
quaternion rotations in f32: a few ulp) and 1e-6 on the gyro and the
biases; the bias walk's std within 15% of bias_std * sqrt(T dt) (the bar
of tests/test_randomization.py:154-175); the reset draws inside their
ranges, spread over at least 80% of them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.config.sensor_config import sensor_configs as j_cfgs
from aerial_gym_simulator_tpu.sensors import imu as j_imu
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config import sensor_configs as t_cfgs
from aerial_gym_simulator_tpu_torch.sensors import imu as t_imu
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.utils.math import get_euler_xyz_tensor

N = 8
IMU_CONFIGS = ("BaseImuConfig", "BoschBmi088Config", "VN100Config")
T = lambda a: torch.from_numpy(np.array(a, np.float32))


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """Many tiny eager ops: one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _leaves_match(port_rec, ref_rec):
    for k, v in ref_rec.items():
        if isinstance(v, (bool, str)):
            assert port_rec[k] == v, k
        else:
            np.testing.assert_allclose(np.asarray(port_rec[k], np.float64),
                                       np.asarray(v, np.float64), atol=1e-6, rtol=0, err_msg=k)


@pytest.mark.parametrize("name", IMU_CONFIGS)
def test_build_imu_params_matches_jax(name):
    jc, tc = getattr(j_cfgs, name)(), getattr(t_cfgs, name)()
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    jp = j_imu.build_imu_params(jc)
    tp = t_imu.build_imu_params(tc, "cpu")
    _leaves_match(record_to_numpy(tp), record_to_numpy(jp))
    assert tp.randomize_placement == (name != "BaseImuConfig")


@pytest.fixture(scope="module")
def jax_imu_env():
    jenv = JSimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                   "lee_position_control", num_envs=N, seed=6)
    jenv.reset()
    rs = np.random.RandomState(11)
    q = rs.normal(size=(N, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    mq = np.array([0.02, -0.03, 0.01, 1.0], np.float32) + 0.01 * rs.normal(size=(N, 4))
    mq = (mq / np.linalg.norm(mq, axis=-1, keepdims=True)).astype(np.float32)
    f = lambda x: jnp.asarray(x, jnp.float32)
    js = jenv.state.replace(
        quat=f(q), angvel=f(rs.uniform(-2, 2, (N, 3))),
        applied_force_b=f(rs.uniform(-3, 3, (N, 3)) + np.array([0.0, 0.0, 9.0])),
        imu_accel_bias=f(rs.uniform(-1e-3, 1e-3, (N, 3))),
        imu_gyro_bias=f(rs.uniform(-1e-3, 1e-3, (N, 3))),
        imu_mount_quat=f(mq))
    return jenv, js


def _jax_draws(key):
    """The normal draws JAX's imu_measurement takes from ``key``."""
    ks = jax.random.split(key, 4)
    z = [T(jax.random.normal(k, (N, 3))) for k in ks]
    return t_imu.ImuDraws(accel_bias=z[0], gyro_bias=z[1], accel_noise=z[2], gyro_noise=z[3])


@pytest.mark.parametrize("flags", [
    {}, dict(world_frame=True), dict(gravity_compensation=True),
    dict(world_frame=True, gravity_compensation=True), dict(enable_noise=False),
    dict(enable_bias=False), dict(enable_noise=False, enable_bias=False),
    dict(max_measurement_acceleration=5.0, max_measurement_angular_velocity=0.5),
], ids=lambda d: "-".join(sorted(d)) or "default")
def test_imu_measurement_matches_jax(jax_imu_env, flags):
    jenv, js = jax_imu_env
    jp = jenv.params.replace(imu=j_imu.build_imu_params(j_cfgs.BoschBmi088Config(**flags)))
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu")
    key = jax.random.PRNGKey(sum(map(ord, str(sorted(flags)))))
    j_out = [np.asarray(x) for x in j_imu.imu_measurement(jp, js, key)]
    t_out = t_imu.imu_measurement(tp, ts, draws=_jax_draws(key))
    for got, want, atol, name in zip(t_out, j_out, (2e-5, 1e-6, 1e-6, 1e-6),
                                     ("accel", "gyro", "accel_bias", "gyro_bias")):
        assert got.shape == (N, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=atol, rtol=0, err_msg=name)
    if "max_measurement_acceleration" in flags:
        assert float(t_out[0].abs().max()) == 5.0 and float(t_out[1].abs().max()) == 0.5


def test_bias_random_walk_grows_with_sqrt_time():
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                      "lee_attitude_control", device="cpu", num_envs=2048,
                                      seed=3)
    ip = env.params.imu
    st = replace(env.state, imu_accel_bias=torch.zeros(2048, 3),
                 imu_gyro_bias=torch.zeros(2048, 3))
    steps = 100
    for _ in range(steps):
        _, _, ab, gb = t_imu.imu_measurement(env.params, st)
        st = replace(st, imu_accel_bias=ab, imu_gyro_bias=gb)
    for bias, std in ((st.imu_accel_bias, ip.accel_bias_std), (st.imu_gyro_bias,
                                                               ip.gyro_bias_std)):
        expected = float(std.mean()) * np.sqrt(steps * env.params.dt)
        measured = float(bias.std())
        assert 0.85 * expected < measured < 1.15 * expected, (measured, expected)


def test_reset_draws_biases_and_mount_inside_their_ranges():
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                      "lee_attitude_control", device="cpu", num_envs=1024,
                                      seed=4)
    st = env.state
    unit = torch.tensor([0.0, 0.0, 0.0, 1.0])
    assert torch.equal(st.imu_mount_quat, unit.expand(1024, 4))         # no placement draw
    env.params = replace(env.params, imu=t_imu.build_imu_params(t_cfgs.BoschBmi088Config(), "cpu"))
    env.reset()
    st, ip = env.state, env.params.imu
    for bias, init in ((st.imu_accel_bias, ip.accel_bias_init),
                       (st.imu_gyro_bias, ip.gyro_bias_init)):
        assert bool((bias.abs() <= init).all())
        assert bool((bias.max(0).values - bias.min(0).values > 1.6 * init).all())
    euler = get_euler_xyz_tensor(st.imu_mount_quat)
    euler = torch.remainder(euler + np.pi, 2 * np.pi) - np.pi
    lo, hi = ip.min_mount_euler_rad, ip.max_mount_euler_rad
    assert bool(((euler >= lo - 1e-6) & (euler <= hi + 1e-6)).all())
    assert bool((euler.max(0).values - euler.min(0).values > 0.8 * (hi - lo)).all())
    # a masked reset redraws only the masked envs
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    mask = torch.zeros(1024)
    mask[:10] = 1.0
    before = env.state
    after = dynamics.reset_envs(env.params, before, mask)
    assert torch.equal(after.imu_accel_bias[10:], before.imu_accel_bias[10:])
    assert not torch.equal(after.imu_accel_bias[:10], before.imu_accel_bias[:10])


def test_hover_reads_gravity_as_specific_force():
    """A hovering quad's accelerometer reads about +9.81 m/s^2 on z (the
    thrust's specific force), its gyro about zero."""
    n = 8
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                      "lee_position_control", device="cpu", num_envs=n, seed=5)
    st = env.state
    env.state = replace(st, pos=torch.zeros(n, 3), linvel=torch.zeros(n, 3),
                        angvel=torch.zeros(n, 3),
                        quat=torch.tensor([0.0, 0.0, 0.0, 1.0]).expand(n, 4).clone())
    for _ in range(60):
        env.step(torch.zeros(n, 4))
    accel, gyro, _, _ = t_imu.imu_measurement(env.params, env.state)
    assert abs(float(accel[:, 2].mean()) - 9.81) < 0.3, accel
    assert float(accel[:, :2].abs().max()) < 0.5 and float(gyro.abs().max()) < 0.5
