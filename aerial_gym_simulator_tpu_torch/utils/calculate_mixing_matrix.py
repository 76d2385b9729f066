"""Allocation (mixing) matrix calculator.

The port's copy of ``aerial_gym_simulator_tpu/utils/calculate_mixing_matrix.py``
(the reference's calculate_mixing_matrix notebook): the 6 x M wrench
allocation matrix from motor geometry (positions, thrust axes and spin
directions), so new airframes can be added from CAD numbers. numpy float64,
the same arithmetic.

Rows are [fx fy fz tx ty tz] per unit motor thrust:
    force  column_i = axis_i
    torque column_i = r_i x axis_i  -  cq * dir_i * axis_i
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def calculate_mixing_matrix(motor_positions: Sequence[Sequence[float]],
                            motor_axes: Sequence[Sequence[float]] = None,
                            motor_directions: Sequence[int] = None,
                            thrust_to_torque_ratio: float = 0.01) -> np.ndarray:
    """6 x M allocation matrix from motor geometry.

    motor_positions: (M, 3) in the body frame.
    motor_axes: (M, 3) unit thrust directions (default +z).
    motor_directions: (M,) +-1 prop spin (reaction-torque sign).
    """
    pos = np.asarray(motor_positions, np.float64)
    M = pos.shape[0]
    axes = (np.asarray(motor_axes, np.float64) if motor_axes is not None
            else np.tile([0.0, 0.0, 1.0], (M, 1)))
    axes = axes / np.linalg.norm(axes, axis=1, keepdims=True)
    dirs = (np.asarray(motor_directions, np.float64)
            if motor_directions is not None
            else np.array([(-1.0) ** i for i in range(M)]))

    alloc = np.zeros((6, M))
    for i in range(M):
        alloc[0:3, i] = axes[i]
        alloc[3:6, i] = np.cross(pos[i], axes[i]) \
            - thrust_to_torque_ratio * dirs[i] * axes[i]
    return alloc


def verify_mixing_matrix(alloc: np.ndarray) -> dict:
    """Rank / conditioning report (the notebook's sanity checks)."""
    alloc = np.asarray(alloc, np.float64)
    rank = int(np.linalg.matrix_rank(alloc))
    s = np.linalg.svd(alloc, compute_uv=False)
    nz = s[s > 1e-12]
    return {
        "rank": rank,
        "fully_actuated": rank == 6,
        "condition_number": float(nz[0] / nz[-1]) if len(nz) else float("inf"),
        "hover_thrusts": (np.linalg.pinv(alloc)
                          @ np.array([0, 0, 1.0, 0, 0, 0])),
    }
