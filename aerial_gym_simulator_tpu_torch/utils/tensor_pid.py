"""Batched PID controller with anti-windup (reference utils/tensor_pid.py).

Counterpart of ``aerial_gym_simulator_tpu/utils/tensor_pid.py``: the
controller state (integral, previous error, reset flag) is an explicit
record, and ``update`` returns a new one instead of mutating buffers, so the
controller composes with any loop that carries its state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device
from .math import tensor_clamp


class PIDState(NamedTuple):
    integral: torch.Tensor       # (N, D)
    prev_error: torch.Tensor     # (N, D)
    just_reset: torch.Tensor     # (N, D) 1.0 right after a reset (skip the D term)


class TensorPID:
    """Gains and limits are fixed tensors on ``device`` (CUDA unless
    ``device="cpu"``); call ``update(state, error) -> (state, out)``."""

    def __init__(self, num_envs, num_dims, Kp, Kd, Ki, dt,
                 integral_min_limit, integral_max_limit,
                 derivative_saturation_min_limit,
                 derivative_saturation_max_limit,
                 output_min_limit, output_max_limit, device=None):
        self.num_envs = num_envs
        self.num_dims = num_dims
        self.device = resolve_device(device)
        f = lambda v: torch.as_tensor(v, dtype=torch.float32, device=self.device)
        self.Kp, self.Kd, self.Ki = f(Kp), f(Kd), f(Ki)
        self.dt = float(dt)
        self.integral_min = f(integral_min_limit)
        self.integral_max = f(integral_max_limit)
        self.deriv_min = f(derivative_saturation_min_limit)
        self.deriv_max = f(derivative_saturation_max_limit)
        self.out_min = f(output_min_limit)
        self.out_max = f(output_max_limit)

    def init_state(self) -> PIDState:
        z = torch.zeros((self.num_envs, self.num_dims), device=self.device)
        return PIDState(integral=z, prev_error=z, just_reset=torch.ones_like(z))

    def update(self, state: PIDState, error: torch.Tensor):
        integral = state.integral + error * self.dt
        p_term = self.Kp * error
        d_term = self.Kd * (1.0 - state.just_reset) * (error - state.prev_error) / self.dt
        i_term = tensor_clamp(self.Ki * integral, self.integral_min, self.integral_max)
        d_term = tensor_clamp(d_term, self.deriv_min, self.deriv_max)
        out = tensor_clamp(p_term + d_term + i_term, self.out_min, self.out_max)
        new_state = PIDState(integral=integral, prev_error=error,
                             just_reset=torch.zeros_like(state.just_reset))
        return new_state, out

    def reset(self, state: PIDState) -> PIDState:
        return self.init_state()

    def reset_idx(self, state: PIDState, mask: torch.Tensor) -> PIDState:
        """Masked reset (mask: (N,) bool or 0/1) on the device: nothing is
        read back to the host."""
        m = mask.reshape(-1, 1).to(torch.bool)
        z = torch.zeros_like(state.integral)
        return PIDState(
            integral=torch.where(m, z, state.integral),
            prev_error=torch.where(m, z, state.prev_error),
            just_reset=torch.where(m, torch.ones_like(z), state.just_reset),
        )
