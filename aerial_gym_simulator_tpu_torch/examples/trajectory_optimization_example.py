"""Trajectory optimization straight through the simulator (gradient MPC).

Counterpart of the repository's ``examples/trajectory_optimization_example.py``,
the third of the differentiable-simulation examples (with
``differentiable_sysid_example`` and ``tune_controllers --grad``): instead
of identifying parameters or tuning a controller, it optimizes the control
inputs themselves, a per-motor thrust sequence (``no_control``, the rawest
actuation the simulator has), by reverse-mode autograd through the whole
rollout: motor lag, allocation, drag, 6-DoF integration.

Adam under a cosine decay of its step size (``LambdaLR`` with
optax.cosine_decay_schedule's formula) on terminal-weighted tracking,
terminal hover, effort and smoothness flies the quad from rest at the
origin to a goal 1 m away on each axis and stops there, with no controller
and no RL.

    python -m aerial_gym_simulator_tpu_torch.examples.trajectory_optimization_example
        [--steps 100] [--iters 1000] [--lr 0.05] [--goal 1 1 1] [--cpu]
"""

from __future__ import annotations

import argparse
import math

import torch

from ..sim.dynamics import env_step
from ..sim.sim_builder import SimBuilder
from ..sim.structs import replace
from ..utils.device import resolve_device

HOVER_THRUST = 0.6133  # N per motor, base_quadrotor at 0.25 kg (mg/4)


def build(num_envs: int, device=None):
    """(params, the hover state at the origin) of base_quadrotor under
    no_control."""
    env = SimBuilder().build_env(
        sim_name="base_sim", env_name="empty_env",
        robot_name="base_quadrotor", controller_name="no_control",
        num_envs=num_envs, seed=0, device=resolve_device(device))
    env.reset()
    st = env.state
    dev = st.device
    state0 = replace(
        st,
        pos=torch.zeros((num_envs, 3), device=dev),
        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).repeat(num_envs, 1),
        linvel=torch.zeros((num_envs, 3), device=dev),
        angvel=torch.zeros((num_envs, 3), device=dev),
        motor_thrust=torch.full_like(st.motor_thrust, HOVER_THRUST))
    return env.params, state0


def make_cost(params, state0, goal: torch.Tensor):
    """-> (rollout(u) -> (pos, linvel, angvel) each (T, N, 3), cost(u) ->
    0-d): terminal-weighted tracking + terminal position, speed and spin +
    effort + smoothness, as the JAX example weighs them."""

    def rollout(u):
        st = state0
        pos, lv, av = [], [], []
        for a in u:
            st = env_step(params, st, a)
            pos.append(st.pos)
            lv.append(st.linvel)
            av.append(st.angvel)
        return torch.stack(pos), torch.stack(lv), torch.stack(av)

    def cost(u):
        T = u.shape[0]
        pos, lv, av = rollout(u)
        w = torch.linspace(0.0, 1.0, T, device=u.device)[:, None, None] ** 4  # terminal emphasis
        track = torch.mean(w * (pos - goal) ** 2)
        terminal = (torch.sum((pos[-1] - goal) ** 2)
                    + 0.1 * torch.sum(lv[-1] ** 2)
                    + 0.05 * torch.sum(av[-1] ** 2))
        effort = 1e-3 * torch.mean((u - HOVER_THRUST) ** 2)
        smooth = 1e-3 * torch.mean((u[1:] - u[:-1]) ** 2)
        return track + terminal + effort + smooth

    return rollout, cost


def cosine_decay(decay_steps: int, alpha: float = 0.0):
    """optax.cosine_decay_schedule's factor of the initial value at step
    ``count``, for ``LambdaLR``."""
    def factor(count):
        count = min(count, decay_steps)
        return (1 - alpha) * 0.5 * (1 + math.cos(math.pi * count / decay_steps)) + alpha
    return factor


def optimize(cost, u0: torch.Tensor, iters: int, lr: float, on_iter=None):
    """Adam from ``u0`` under the cosine decay over ``iters`` -> (u, costs
    (iters,) on the device, each before its step)."""
    u = u0.clone().requires_grad_()
    opt = torch.optim.Adam([u], lr=lr, eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay(iters))
    costs = []
    for it in range(iters):
        opt.zero_grad()
        c = cost(u)
        c.backward()
        if on_iter is not None:
            on_iter(it, c.detach())
        opt.step()
        sched.step()
        costs.append(c.detach())
    return u.detach(), torch.stack(costs)


def build_parser():
    ap = argparse.ArgumentParser(description="a motor-thrust trajectory optimized through the simulator")
    ap.add_argument("--steps", type=int, default=100,
                    help="horizon in env steps (dt=0.01 -> 1 s default)")
    ap.add_argument("--iters", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--goal", type=float, nargs=3, default=[1.0, 1.0, 1.0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    N, T = 1, args.steps
    params, state0 = build(N, device)
    goal = torch.tensor(args.goal, dtype=torch.float32, device=device)
    rollout, cost = make_cost(params, state0, goal)

    def report(it, c):
        if it % 250 == 0 or it == args.iters - 1:
            print(f"iter {it:5d} cost {float(c):.5f}")

    u0 = torch.full((T, N, 4), HOVER_THRUST, device=device)  # warm start: hover
    u, costs = optimize(cost, u0, args.iters, args.lr, on_iter=report)
    with torch.no_grad():
        pos, lv, _ = rollout(u)
    dist = float(torch.linalg.norm(pos[-1, 0] - goal))
    speed = float(torch.linalg.norm(lv[-1, 0]))
    print(f"terminal position {pos[-1, 0].cpu().numpy().round(4)} "
          f"(goal {goal.cpu().numpy()})")
    print(f"terminal error {dist * 1000:.1f} mm, terminal speed "
          f"{speed:.3f} m/s: a pure motor-command trajectory, no controller")
    return u, costs


if __name__ == "__main__":
    main()
