"""Gradient-based system identification through the simulator.

Counterpart of the repository's ``examples/differentiable_sysid_example.py``.
The reference's physics core (PhysX inside Isaac Gym) is a closed binary, so
its sys-id tooling fits closed-form models to logged data outside the
simulator. Here ``sim/dynamics.env_step`` is plain differentiable torch, so
a whole rollout (motor lag, control allocation, drag wrench, 6-DoF
integration) carries gradients, and unknown physical parameters can be
recovered by gradient descent on a trajectory-matching loss.

The example "measures" a trajectory of a quad with known motor time
constants and linear drag, then recovers both from a deliberately wrong
guess by Adam (``torch.optim.Adam``, optax.adam's update with eps 1e-8) on
the mean squared trajectory error, the parameters in log space. The same
recipe identifies any SimParams / SimState leaf (inertia, gains, thrust
constants...) from real flight logs.

    python -m aerial_gym_simulator_tpu_torch.examples.differentiable_sysid_example
        [--num_envs 4] [--steps 100] [--iters 300] [--lr 0.05] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..sim.dynamics import env_step
from ..sim.sim_builder import SimBuilder
from ..sim.structs import replace
from ..utils.device import resolve_device

TRUE_THETA = {"tau": 0.08, "drag": [0.15, 0.12, 0.25]}
INITIAL_THETA = {"tau": 0.025, "drag": [0.5, 0.5, 0.05]}


def build(num_envs: int, seed: int = 3, device=None):
    env = SimBuilder().build_env(
        sim_name="base_sim",
        env_name="empty_env",
        robot_name="base_quadrotor",
        controller_name="lee_velocity_control",
        num_envs=num_envs,
        seed=seed,
        device=resolve_device(device),
    )
    env.reset()
    return env


def excitation(num_envs: int, steps: int, device=None) -> torch.Tensor:
    """Sinusoid velocity commands rich enough to excite drag and motor lag
    -> (steps, num_envs, 4) float32."""
    t = np.arange(steps)[:, None, None] * 0.01
    phase = np.arange(num_envs)[None, :, None] * 0.7
    cmd = np.concatenate(
        [1.5 * np.sin(6.0 * t + phase),
         1.0 * np.sin(9.0 * t + 1.3 + phase),
         0.8 * np.sin(4.0 * t + 2.1 + phase),
         0.5 * np.sin(3.0 * t + phase)], axis=2)
    return torch.as_tensor(cmd, dtype=torch.float32, device=resolve_device(device))


def make_rollout(params, state0, actions_seq):
    """theta -> (T, N, 6) pos + linvel trajectory, differentiable in theta
    ({"tau": 0-d, "drag": (3,)} tensors)."""

    def apply_theta(theta):
        p = replace(params, robot=replace(params.robot, drag_lin_linear=theta["drag"]))
        tau = theta["tau"]
        st = replace(state0,
                     motor_tau_inc=tau.expand_as(state0.motor_tau_inc),
                     motor_tau_dec=tau.expand_as(state0.motor_tau_dec))
        return p, st

    def rollout(theta):
        p, st = apply_theta(theta)
        traj = []
        for a in actions_seq:
            st = env_step(p, st, a)
            traj.append(torch.cat([st.pos, st.linvel], dim=-1))
        return torch.stack(traj)

    return rollout


def theta_tensors(theta: dict, device) -> dict:
    return {k: torch.as_tensor(v, dtype=torch.float32, device=device) for k, v in theta.items()}


def sysid_loss(rollout, measured, log_theta: dict) -> torch.Tensor:
    """Mean squared trajectory error at exp(log_theta)."""
    theta = {k: torch.exp(v) for k, v in log_theta.items()}
    return torch.mean((rollout(theta) - measured) ** 2)


def identify(rollout, measured, iters: int, lr: float, on_iter=None):
    """Adam in log space from INITIAL_THETA: each iteration takes the loss and
    its gradient at the current parameters, then steps. ``on_iter(it, loss,
    log_theta)`` sees each iteration before its step. -> (log_theta, losses
    (iters,) on the device)."""
    dev = measured.device
    log_theta = {k: torch.log(v).requires_grad_() for k, v in
                 theta_tensors(INITIAL_THETA, dev).items()}
    opt = torch.optim.Adam(list(log_theta.values()), lr=lr, eps=1e-8)
    losses = []
    for it in range(iters):
        opt.zero_grad()
        loss = sysid_loss(rollout, measured, log_theta)
        loss.backward()
        if on_iter is not None:
            on_iter(it, loss.detach(), log_theta)
        opt.step()
        losses.append(loss.detach())
    return log_theta, torch.stack(losses)


def build_parser():
    ap = argparse.ArgumentParser(description="motor tau and drag recovered through the simulator")
    ap.add_argument("--num_envs", type=int, default=4)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--iters", type=int, default=300)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the default is CUDA, which must be available)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    env = build(args.num_envs, device=device)
    actions = excitation(args.num_envs, args.steps, device)
    rollout = make_rollout(env.params, env.state, actions)

    # the ground truth: the catalog quad's motor tau with a custom drag vector
    true_theta = theta_tensors(TRUE_THETA, device)
    with torch.no_grad():
        measured = rollout(true_theta)

    def report(it, loss, log_theta):
        if it % 50 == 0 or it == args.iters - 1:
            th = {k: torch.exp(v.detach()) for k, v in log_theta.items()}
            print(f"iter {it:4d} loss {float(loss):.3e} "
                  f"tau {float(th['tau']):.4f} (true 0.0800) "
                  f"drag {th['drag'].cpu().numpy().round(3)} "
                  f"(true [0.15 0.12 0.25])")

    log_theta, losses = identify(rollout, measured, args.iters, args.lr, on_iter=report)
    th = {k: torch.exp(v.detach()) for k, v in log_theta.items()}
    tau_err = abs(float(th["tau"]) - TRUE_THETA["tau"])
    drag_err = float((th["drag"] - true_theta["drag"]).abs().max())
    print(f"recovered: tau within {tau_err:.2e}, drag within {drag_err:.2e}")
    return th, losses


if __name__ == "__main__":
    main()
