"""First-order motor-lag model with asymmetric time constants.

Counterpart of ``aerial_gym_simulator_tpu/ops/motor_model.py``: reference
thrusts are clamped, the time constant is 'decreasing' when the commanded
change opposes the current thrust sign, the mixing factor is 1/(dt + tau)
(discrete) or 1/tau, and the state integrates in thrust or rpm domain with
Euler or RK4 and a rate clamp at every stage.
"""

from __future__ import annotations

import torch

from ..sim.structs import MotorParams
from ..utils.math import safe_sqrt, tensor_clamp


def _rate(error, mixing_factor, max_rate):
    return tensor_clamp(mixing_factor * error, -max_rate, max_rate)


def _rk4_delta(ref, cur, mixing_factor, max_rate, dt):
    """RK4 on d(state)/dt = clip(mixing*(ref-state)); returns the delta."""
    k1 = _rate(ref - cur, mixing_factor, max_rate)
    k2 = _rate(ref - (cur + 0.5 * dt * k1), mixing_factor, max_rate)
    k3 = _rate(ref - (cur + 0.5 * dt * k2), mixing_factor, max_rate)
    k4 = _rate(ref - (cur + dt * k3), mixing_factor, max_rate)
    return (dt / 6.0) * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


def motor_step(p: MotorParams, dt, ref_thrust, current_thrust, tau_inc, tau_dec,
               thrust_constant) -> torch.Tensor:
    """One dt of motor dynamics on (N, M) tensors; returns the new thrusts."""
    ref_thrust = tensor_clamp(ref_thrust, p.min_thrust, p.max_thrust)
    err = ref_thrust - current_thrust
    tau = torch.where(torch.sign(current_thrust) * torch.sign(err) < 0, tau_dec, tau_inc)
    mixing = 1.0 / (dt + tau) if p.use_discrete_approximation else 1.0 / tau

    if p.use_rps:
        # rpm-domain first-order response: f = kt * w^2
        safe_kt = torch.clamp(thrust_constant, min=1e-12)
        cur_rpm = safe_sqrt(current_thrust / safe_kt)
        des_rpm = safe_sqrt(ref_thrust / safe_kt)
        if p.integration_scheme == "euler":
            new_rpm = cur_rpm + _rate(des_rpm - cur_rpm, mixing, p.max_thrust_rate) * dt
        else:
            new_rpm = cur_rpm + _rk4_delta(des_rpm, cur_rpm, mixing, p.max_thrust_rate, dt)
        return thrust_constant * new_rpm * new_rpm
    if p.integration_scheme == "euler":
        return current_thrust + _rate(err, mixing, p.max_thrust_rate) * dt
    return current_thrust + _rk4_delta(ref_thrust, current_thrust, mixing,
                                       p.max_thrust_rate, dt)
