"""Port parity: Lee controllers and the RK4 motor model against the JAX
package on random robot states (numpy, fixed seed), params carried across
from the JAX builder.

Tolerance: atol 1e-5. The wrench is a chain of ~100 f32 operations on
values of order 1-10 (gains x errors); rounding-order differences between
the two CPU backends stay well below it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from aerial_gym_simulator_tpu.control import controllers as jc
from aerial_gym_simulator_tpu.ops import motor_model as jmm
from aerial_gym_simulator_tpu.sim.params import build_sim_params as j_build_sim_params
from aerial_gym_simulator_tpu.registry.registries import (
    controller_registry as j_ctrl, env_config_registry as j_env,
    robot_registry as j_robot, sim_config_registry as j_sim)
import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)

from aerial_gym_simulator_tpu_torch.control import controllers as tc
from aerial_gym_simulator_tpu_torch.ops import motor_model as tmm
from aerial_gym_simulator_tpu_torch.sim.convert import params_from_numpy, record_to_numpy

ATOL = 1e-5
N = 64


def _params(controller):
    jp = j_build_sim_params(j_sim.make("base_sim"), j_env.make("env_with_obstacles"),
                            j_robot.make("base_quadrotor"), j_ctrl.make(controller),
                            num_envs=N)
    return jp, params_from_numpy(record_to_numpy(jp), "cpu")


def _random_state(rs):
    q = rs.normal(size=(N, 4)).astype(np.float32)
    q[:, 3] += 3.0                                  # mostly upright
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    pos = rs.uniform(-3, 3, (N, 3)).astype(np.float32)
    lin = rs.uniform(-2, 2, (N, 3)).astype(np.float32)
    ang = rs.uniform(-2, 2, (N, 3)).astype(np.float32)
    gains = [rs.uniform(0.1, 3.0, (N, 3)).astype(np.float32) for _ in range(4)]
    return pos, q, lin, ang, gains


@pytest.mark.parametrize("controller", ["lee_velocity_control", "lee_position_control",
                                        "lee_attitude_control", "lee_acceleration_control",
                                        "magpie_acceleration_control"])
def test_controller_wrench_matches_jax(controller):
    jp, tp = _params(controller)
    rs = np.random.RandomState(11)
    pos, q, lin, ang, gains = _random_state(rs)
    action = rs.uniform(-1.5, 1.5, (N, 4)).astype(np.float32)

    j_obs = jc.compute_robot_obs(*(jnp.asarray(x) for x in (pos, q, lin, ang)))
    assert tp.controller.name == jp.controller.name          # the base controller
    j_w = jc.controller_update(jp.controller.name, jp.controller, jp.robot, jp.gravity, j_obs,
                               jc.Gains(*(jnp.asarray(g) for g in gains)),
                               jnp.asarray(action))
    t_obs = tc.compute_robot_obs(*(torch.from_numpy(x) for x in (pos, q, lin, ang)))
    t_w = tc.controller_update(tp.controller.name, tp.controller, tp.robot, tp.gravity, t_obs,
                               tc.Gains(*(torch.from_numpy(g) for g in gains)),
                               torch.from_numpy(action))
    for field in ("vehicle_linvel", "body_linvel", "body_angvel", "vehicle_quat"):
        np.testing.assert_allclose(getattr(t_obs, field).numpy(),
                                   np.asarray(getattr(j_obs, field)), atol=ATOL)
    np.testing.assert_allclose(t_w.numpy(), np.asarray(j_w), atol=ATOL)


@pytest.mark.parametrize("scheme", ["rk4", "euler"])
def test_motor_step_matches_jax(scheme):
    jp, tp = _params("lee_velocity_control")
    jm = jp.motor.replace(integration_scheme=scheme)
    tp.motor.integration_scheme = scheme
    rs = np.random.RandomState(5)
    M = jm.num_motors
    ref = rs.uniform(-0.5, 2.5, (N, M)).astype(np.float32)
    cur = rs.uniform(0.0, 2.0, (N, M)).astype(np.float32)
    tau_i = rs.uniform(0.01, 0.05, (N, M)).astype(np.float32)
    tau_d = rs.uniform(0.01, 0.05, (N, M)).astype(np.float32)
    kt = rs.uniform(9e-6, 1.8e-5, (N, M)).astype(np.float32)
    out_j = jmm.motor_step(jm, jp.dt, *(jnp.asarray(x) for x in (ref, cur, tau_i, tau_d, kt)))
    out_t = tmm.motor_step(tp.motor, tp.dt, *(torch.from_numpy(x)
                                              for x in (ref, cur, tau_i, tau_d, kt)))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL)


def test_controller_plus_motor_chain_matches_jax():
    """lee_velocity_control -> allocation pinv -> motor_step, one substep's
    actuation chain end to end."""
    jp, tp = _params("lee_velocity_control")
    rs = np.random.RandomState(23)
    pos, q, lin, ang, gains = _random_state(rs)
    action = rs.uniform(-1.0, 1.0, (N, 4)).astype(np.float32)
    M = jp.motor.num_motors
    cur = rs.uniform(0.3, 1.0, (N, M)).astype(np.float32)
    tau = np.full((N, M), 0.04, np.float32)
    kt = np.full((N, M), 1.4e-5, np.float32)

    j_obs = jc.compute_robot_obs(*(jnp.asarray(x) for x in (pos, q, lin, ang)))
    j_w = jc.controller_update("lee_velocity_control", jp.controller, jp.robot, jp.gravity,
                               j_obs, jc.Gains(*(jnp.asarray(g) for g in gains)),
                               jnp.asarray(action))
    j_ref = jnp.einsum("mk,nk->nm", jp.motor.allocation_pinv, j_w)
    j_out = jmm.motor_step(jp.motor, jp.dt, j_ref, jnp.asarray(cur), jnp.asarray(tau),
                           jnp.asarray(tau), jnp.asarray(kt))

    t_obs = tc.compute_robot_obs(*(torch.from_numpy(x) for x in (pos, q, lin, ang)))
    t_w = tc.controller_update("lee_velocity_control", tp.controller, tp.robot, tp.gravity,
                               t_obs, tc.Gains(*(torch.from_numpy(g) for g in gains)),
                               torch.from_numpy(action))
    t_ref = t_w @ tp.motor.allocation_pinv.T
    t_out = tmm.motor_step(tp.motor, tp.dt, t_ref, torch.from_numpy(cur),
                           torch.from_numpy(tau), torch.from_numpy(tau), torch.from_numpy(kt))
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), atol=ATOL)
