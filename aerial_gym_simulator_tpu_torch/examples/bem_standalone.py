"""Standalone blade-element-momentum rotor model (NeuroBEM).

Counterpart of the repository's ``examples/bem_standalone.py`` (reference
aerial_gym/examples/bem_standalone.ipynb): the model-based rotor force and
torque of Bauersfeld et al., "NeuroBEM: Hybrid Aerodynamic Quadrotor Model"
(RSS 2021, https://rpg.ifi.uzh.ch/docs/RSS21_Bauersfeld.pdf).

  * the radial x azimuthal blade-element quadrature is one tensor reduction;
  * the induced-velocity fixed point (momentum thrust == blade-element
    thrust, the paper's eq. 5 against eq. 13) is solved by 48 bisection
    halvings, each a ``torch.where`` (nothing is read back to the host);
  * the flapping-coefficient equilibrium (eq. 16, projected onto
    {1, cos psi, sin psi}) is solved by 8 Newton steps, the 3x3 Jacobian
    from ``torch.func.jacfwd`` and solved by ``torch.linalg.solve``;
  * ``bem_rotor_wrench_batched`` maps the single-rotor model over any batch
    of rotors with ``torch.func.vmap``, so a fleet's rotors evaluate in one
    pass of batched launches.

    python -m aerial_gym_simulator_tpu_torch.examples.bem_standalone [--cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import math
from dataclasses import dataclass
from functools import partial

import torch

from ..utils.device import resolve_device

G = 9.81


@dataclass
class BEMParams:
    """Rotor and blade parameters (the paper's table I), 0-d float32
    tensors on one device."""
    rho: torch.Tensor           # air density [kg/m^3]
    radius: torch.Tensor        # rotor radius R [m]
    n_blades: torch.Tensor      # blade count b
    chord: torch.Tensor         # chord length c [m]
    cd0: torch.Tensor           # zero-lift drag coefficient
    cl0: torch.Tensor           # lift-coefficient slope
    theta0: torch.Tensor        # blade root pitch [rad]
    theta1: torch.Tensor        # blade twist [rad]
    k_beta: torch.Tensor        # flapping-hinge spring stiffness [N m/rad]
    hinge_offset: torch.Tensor  # hinge offset e [m]
    blade_inertia: torch.Tensor  # blade flapping inertia I_b [kg m^2]
    blade_mass: torch.Tensor     # single-blade mass m_b [kg]


def bem_params_from_numpy(d: dict, device) -> BEMParams:
    """BEMParams from a dict of field -> number or array (JAX's parameters
    carried across)."""
    dev = torch.device(device)
    return BEMParams(**{f.name: torch.as_tensor(float(d[f.name]), dtype=torch.float32,
                                                device=dev)
                        for f in dataclasses.fields(BEMParams)})


def default_params(device=None) -> BEMParams:
    """The notebook's example 2.5-inch 3-blade racing propeller, on
    ``device`` (CUDA unless ``device="cpu"``)."""
    r = 5.1 * 2.54 / 2 * 0.01
    return bem_params_from_numpy(dict(
        rho=1.204, radius=r, n_blades=3, chord=0.015, cd0=13.53063, cl0=15.20569,
        theta0=21.77 * math.pi / 180, theta1=-11.00 * math.pi / 180, k_beta=7.571,
        hinge_offset=0.01, blade_inertia=0.00122 * 0.0635 ** 2, blade_mass=0.00122,
    ), resolve_device(device))


# quadrature resolution: the reference notebook's discretization
# (dr = R/12.5 from r = 0, dpsi = 2*pi/6), so the numbers line up
_N_RADIAL = 13
_N_AZIMUTH = 6


def _element_velocities(bp: BEMParams, r, psi, omega, v_hor, v_ver, a0, a1, b1):
    """In-plane and out-of-plane flow at a blade element (eqs. 6-7)."""
    u_t = omega * r + v_hor * torch.sin(psi)
    u_p = (v_ver
           - r * omega * (a1 * torch.sin(psi) + b1 * torch.cos(psi))
           + v_ver * (a0 - a1 * torch.cos(psi) - b1 * torch.sin(psi)) * torch.cos(psi))
    return u_t, u_p


def _element_aero(bp: BEMParams, r, psi, omega, v_hor, v_ver, v_i, a0, a1, b1):
    """Per-element inflow angle and lift / drag magnitudes (eqs. 8-12)."""
    u_t, u_p = _element_velocities(bp, r, psi, omega, v_hor, v_ver, a0, a1, b1)
    # the induced velocity enters only the uniform out-of-plane inflow
    # (eq. 7: U_P = v_ver - v_i - ...; the flapping coupling keeps v_ver)
    u_p = u_p - v_i
    phi = torch.atan2(u_p, u_t)
    alpha = bp.theta0 + (r / bp.radius) * bp.theta1 + phi
    cl = bp.cl0 * torch.sin(alpha) * torch.cos(alpha)
    cd = bp.cd0 * torch.sin(alpha) ** 2
    u_sq = u_t ** 2 + u_p ** 2
    lift = bp.chord * cl * u_sq
    drag = bp.chord * cd * u_sq
    return phi, lift, drag


def _bet_integrals(bp: BEMParams, omega, v_hor, v_ver, v_i, a0, a1, b1):
    """Blade-element thrust T, in-plane force H and torque Q (eqs. 13-15),
    one reduction over the (radial x azimuth) grid."""
    dr = bp.radius / 12.5
    dpsi = 2 * math.pi / _N_AZIMUTH
    dev = bp.radius.device
    r = torch.arange(_N_RADIAL, dtype=torch.float32, device=dev)[:, None] * dr
    psi = torch.arange(_N_AZIMUTH, dtype=torch.float32, device=dev)[None, :] * dpsi
    phi, lift, drag = _element_aero(bp, r, psi, omega, v_hor, v_ver, v_i, a0, a1, b1)
    area = dr * dpsi
    t = torch.sum((lift * torch.cos(phi) + drag * torch.sin(phi)) * area)
    h = torch.sum((-lift * torch.sin(phi) + drag * torch.cos(phi)) * torch.sin(psi) * area)
    q = torch.sum((-lift * torch.sin(phi) + drag * torch.cos(phi)) * r * area)
    scale = bp.n_blades * bp.rho / (4 * math.pi)
    return scale * t, scale * h, scale * q


def _momentum_thrust(bp: BEMParams, v_i, v_hor, v_ver):
    """Momentum-theory thrust (eq. 5)."""
    disk = math.pi * bp.radius ** 2
    return 2.0 * v_i * bp.rho * disk * torch.sqrt(v_hor ** 2 + (v_ver - v_i) ** 2)


def _solve_induced_velocity(bp: BEMParams, omega, v_hor, v_ver, n_iter: int = 48):
    """Bisection on f(v_i) = momentum thrust - BET thrust over [1e-4, 60] m/s.

    f is negative at v_i = 0 (the momentum side vanishes) whenever the
    rotor makes thrust, and grows about linearly in v_i, so a sign change is
    bracketed; 48 halvings leave a relative width of ~1e-13, below float32's
    resolution. Each halving is a ``torch.where``: no branch on the host.
    """
    def f(v_i):
        t_bet, _, _ = _bet_integrals(bp, omega, v_hor, v_ver, v_i, 0.0, 0.0, 0.0)
        return _momentum_thrust(bp, v_i, v_hor, v_ver) - t_bet

    dev = bp.radius.device
    lo = torch.tensor(1e-4, dtype=torch.float32, device=dev)
    hi = torch.tensor(60.0, dtype=torch.float32, device=dev)
    for _ in range(n_iter):
        mid = 0.5 * (lo + hi)
        neg = f(mid) < 0.0
        lo, hi = torch.where(neg, mid, lo), torch.where(neg, hi, mid)
    return 0.5 * (lo + hi)


def _flapping_residual(bp: BEMParams, coeffs, omega, v_hor, v_ver, v_i, p, q):
    """Moment-equilibrium residual projected on {1, cos, sin} (eq. 16),
    at mid-span r = R/2 over the azimuth grid, like the notebook."""
    a0, a1, b1 = coeffs[0], coeffs[1], coeffs[2]
    psi = torch.linspace(0.0, 2 * math.pi, _N_AZIMUTH, dtype=torch.float32,
                         device=coeffs.device)
    r = bp.radius / 2.0

    beta = a0 + a1 * torch.cos(psi) + b1 * torch.sin(psi)
    beta_ddot = -(a1 * torch.cos(psi) + b1 * torch.sin(psi)) * omega ** 2

    m_weight = bp.blade_mass * G * bp.hinge_offset * torch.cos(psi)
    m_gyro = bp.blade_inertia * omega * (p * torch.sin(psi) - q * torch.cos(psi))
    m_inertial = bp.blade_inertia * beta_ddot
    m_cf = -bp.blade_mass * omega ** 2 * bp.hinge_offset * bp.radius * torch.sin(beta)
    phi, lift, drag = _element_aero(bp, r, psi, omega, v_hor, v_ver, v_i, a0, a1, b1)
    m_aero = r * (lift * torch.cos(phi) + drag * torch.sin(phi))
    m_spring = bp.k_beta * beta

    m_total = m_weight + m_gyro + m_inertial + m_cf + m_aero + m_spring
    basis = torch.stack([torch.ones_like(psi), torch.cos(psi), torch.sin(psi)])
    return basis @ m_total / _N_AZIMUTH


def _solve_flapping(bp: BEMParams, omega, v_hor, v_ver, v_i, p, q, n_iter: int = 8):
    """Newton steps with the dense 3x3 Jacobian (torch.func.jacfwd)."""
    res = partial(_flapping_residual, bp, omega=omega, v_hor=v_hor, v_ver=v_ver,
                  v_i=v_i, p=p, q=q)
    jac_fn = torch.func.jacfwd(res)
    x = torch.zeros((3,), dtype=torch.float32, device=bp.radius.device)
    for _ in range(n_iter):
        x = x - torch.linalg.solve(jac_fn(x), res(x))
    return x


def _as_f32(bp: BEMParams, v):
    return torch.as_tensor(v, dtype=torch.float32, device=bp.radius.device)


def bem_rotor_wrench(bp: BEMParams, omega, v_hor, v_ver, p, q, clockwise):
    """Force and torque of one rotor in the propeller frame.

    The arguments follow the reference notebook's ``bem_algorithm``: rotor
    speed omega [rad/s], horizontal and vertical airspeed [m/s], body roll
    and pitch rates p, q [rad/s], spin direction (clockwise as 1.0 / -1.0 or
    a bool); numbers or 0-d tensors.

    Returns (force (3,), torque (3,)), the notebook's convention: thrust
    along -z of the prop frame, the hub force tilted by the first-harmonic
    flapping angles, the hinge spring's roll / pitch moments and the
    aerodynamic drag torque about z.
    """
    omega, v_hor, v_ver, p, q = (_as_f32(bp, v) for v in (omega, v_hor, v_ver, p, q))
    clockwise = _as_f32(bp, clockwise)
    sign = torch.where(clockwise > 0, -1.0, 1.0)

    v_i = _solve_induced_velocity(bp, omega, v_hor, v_ver)
    a0, a1, b1 = _solve_flapping(bp, omega, v_hor, v_ver, v_i, p, q)
    t, h, q_aero = _bet_integrals(bp, omega, v_hor, v_ver, v_i, a0, a1, b1)

    force = torch.stack([-(h + torch.sin(a1) * t),
                         sign * torch.sin(b1) * t,
                         -t * torch.cos(a0)])
    torque = torch.stack([sign * bp.k_beta * b1,
                          bp.k_beta * a1,
                          -sign * q_aero])
    return force, torque


def bem_rotor_wrench_batched(bp: BEMParams, omega, v_hor, v_ver, p, q, clockwise):
    """``bem_rotor_wrench`` over any batch of rotors: the arguments
    broadcast together to a shape S; returns (force (*S, 3), torque
    (*S, 3))."""
    args = torch.broadcast_tensors(*(_as_f32(bp, v) for v in (omega, v_hor, v_ver, p, q,
                                                               clockwise)))
    shape = args[0].shape
    flat = [a.reshape(-1) for a in args]
    force, torque = torch.func.vmap(bem_rotor_wrench, in_dims=(None, 0, 0, 0, 0, 0, 0))(
        bp, *flat)
    return force.reshape(shape + (3,)), torque.reshape(shape + (3,))


def main(argv=None):
    ap = argparse.ArgumentParser(description="the NeuroBEM rotor model")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    args = ap.parse_args(argv)
    bp = default_params("cpu" if args.cpu else None)
    # the notebook's example cell: about hover
    force, torque = bem_rotor_wrench(bp, 2000.0, 0.0, 0.0, 0.0, 0.0, 1.0)
    print("single rotor @ 2000 rad/s hover:")
    print("  force  [N]  :", [float(v) for v in force])
    print("  torque [N*m]:", [float(v) for v in torque])
    hover_per_rotor = 0.372 * G / 4  # the notebook's sanity number
    print(f"  vehicle hover thrust needed per rotor: {hover_per_rotor:.3f} N")

    # batched: one quad's 4 rotors with alternating spin in one pass
    dev = bp.radius.device
    omegas = torch.tensor([1800.0, 1900.0, 2000.0, 2100.0], device=dev)
    z = torch.zeros(4, device=dev)
    spins = torch.tensor([1.0, -1.0, 1.0, -1.0], device=dev)
    forces, torques = bem_rotor_wrench_batched(bp, omegas, z, z, z, z, spins)
    print("batched quad rotor thrusts [N]:", [float(-f[2]) for f in forces])
    return force, torque, forces, torques


if __name__ == "__main__":
    main()
