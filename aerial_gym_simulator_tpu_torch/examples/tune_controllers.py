"""Controller tuning harness (reference examples/tune_controllers.py).

Counterpart of the repository's ``examples/tune_controllers.py``: measures
step-response metrics (rise time, settling time, overshoot, steady-state
error) of each Lee controller axis over the whole env batch, so gain ranges
can be tuned against numbers rather than by watching the viewer.

``--grad`` first tunes the position / velocity gains by gradient descent
through the differentiable rollout: ``env_step`` is plain torch, so
d(step-response cost)/d(gains) is exact reverse-mode autograd, which the
reference's closed PhysX binary cannot give (its tuning loop can only
sample and measure).

    python -m aerial_gym_simulator_tpu_torch.examples.tune_controllers
        [--robot base_quadrotor] [--num_envs 256] [--steps 400] [--grad]
        [--grad_iters 150] [--cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..control.controllers import compute_robot_obs
from ..sim.dynamics import env_step
from ..sim.sim_builder import SimBuilder
from ..sim.structs import replace
from ..utils.device import resolve_device
from ..utils.math import get_euler_xyz_tensor, ssa

CASES = [
    ("lee_position_control", 0, 1.0, "x position -> 1 m"),
    ("lee_position_control", 2, 1.0, "z position -> 1 m"),
    ("lee_velocity_control", 0, 1.0, "x velocity -> 1 m/s"),
    ("lee_attitude_control", 1, 0.2, "roll -> 0.2 rad"),
]


def step_response_metrics(t, y, target, tol=0.05):
    """Classic step metrics from a (T,) response trace."""
    y = np.asarray(y, np.float64)
    yf = target
    rng = abs(yf) if abs(yf) > 1e-6 else 1.0
    # rise time: 10% -> 90%
    try:
        t10 = t[np.argmax(y >= 0.1 * yf)]
        t90 = t[np.argmax(y >= 0.9 * yf)]
        rise = t90 - t10
    except Exception:
        rise = float("nan")
    overshoot = max(0.0, (np.max(y) - yf) / rng) * 100.0
    settled = np.abs(y - yf) <= tol * rng
    # the last time it was not settled
    not_settled = np.where(~settled)[0]
    settling = t[not_settled[-1]] + (t[1] - t[0]) if len(not_settled) else 0.0
    sse = abs(np.mean(y[-max(len(y) // 10, 1):]) - yf)
    return dict(rise_time=rise, overshoot_pct=overshoot,
                settling_time=settling, steady_state_error=sse)


def rest_state(env):
    """The step-response initial condition: at rest at the origin."""
    st = env.state
    n = st.pos.shape[0]
    return replace(
        st,
        pos=torch.zeros_like(st.pos),
        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=st.device).repeat(n, 1),
        linvel=torch.zeros_like(st.linvel), angvel=torch.zeros_like(st.angvel),
        motor_thrust=torch.zeros_like(st.motor_thrust))


def sim_dt(params):
    """Env-step duration (physics dt x control-rate decimation)."""
    return float(params.dt) * params.env.substep_mean


def build_env(robot, controller, num_envs, device=None):
    """The tuning env: ``robot`` under ``controller`` in the empty env,
    seed 0, after its first reset."""
    env = SimBuilder().build_env("base_sim", "empty_env", robot, controller,
                                 num_envs=num_envs, seed=0, device=resolve_device(device))
    env.reset()
    return env


def run_axis(controller, axis, target, steps, num_envs, robot, device=None):
    """The env-mean response of one controller axis to a step command of
    ``target`` from rest -> (t (T,), y (T,)) numpy."""
    env = build_env(robot, controller, num_envs, device)
    env.state = rest_state(env)

    n_act = env.params.controller.num_actions
    action = torch.zeros((num_envs, n_act), device=env.state.device)
    action[:, axis] = target
    if controller == "lee_attitude_control":
        action[:, 0] = 0.0          # a zero-offset thrust command hovers

    trace = []
    dt = sim_dt(env.params)
    for _ in range(steps):
        env.step(action)
        s = env.state
        if controller == "lee_position_control":
            y = s.pos[:, axis]
        elif controller == "lee_velocity_control":
            y = compute_robot_obs(s.pos, s.quat, s.linvel, s.angvel).vehicle_linvel[:, axis]
        elif controller == "lee_attitude_control":
            y = ssa(get_euler_xyz_tensor(s.quat))[:, axis - 1]  # axis 1 -> roll
        else:
            y = compute_robot_obs(s.pos, s.quat, s.linvel, s.angvel).body_angvel[:, axis - 1]
        trace.append(y.mean())
    t = np.arange(steps) * dt
    return t, torch.stack(trace).cpu().numpy()


def tune_problem(robot: str, steps: int, num_envs: int, device=None):
    """The gradient-tuning problem: a [1, 0, 1] m position step from rest
    under lee_position_control -> (params, rest state, response(kp, kv) ->
    pos (T, N, 3), cost(log_g) -> 0-d). The cost is the settling-weighted
    squared tracking error plus an overshoot penalty; log_g = {"kp", "kv"}
    holds the gains' logs (positive by construction)."""
    env = build_env(robot, "lee_position_control", num_envs, device)
    st0 = rest_state(env)
    params = env.params
    dev = st0.device
    target = torch.tensor([1.0, 0.0, 1.0], device=dev)
    action = torch.tensor([[1.0, 0.0, 1.0, 0.0]], device=dev).repeat(num_envs, 1)

    def response(kp, kv):
        st = replace(st0, K_pos=kp.expand(num_envs, 3), K_vel=kv.expand(num_envs, 3))
        pos = []
        for _ in range(steps):
            st = env_step(params, st, action)
            pos.append(st.pos)
        return torch.stack(pos)  # (T, N, 3)

    def cost(log_g):
        pos = response(torch.exp(log_g["kp"]), torch.exp(log_g["kv"]))
        err = pos - target
        w = torch.linspace(0.2, 1.0, steps, device=dev)[:, None, None]  # settling-weighted
        overshoot = torch.clamp(pos - target, min=0.0)
        return torch.mean(w * err ** 2) + 4.0 * torch.mean(overshoot ** 2)

    return params, st0, response, cost


def grad_tune(robot: str, steps: int = 120, iters: int = 150, lr: float = 0.03,
              num_envs: int = 4, device=None, echo: bool = True):
    """Gradient-optimize the Lee position / velocity gains through the
    rollout with Adam in log space -> (tuned K_pos, tuned K_vel, costs
    (iters,) on the device, each before its step)."""
    params, st0, response, cost = tune_problem(robot, steps, num_envs, device)
    kp0, kv0 = st0.K_pos[0].clone(), st0.K_vel[0].clone()
    log_g = {"kp": torch.log(kp0).requires_grad_(), "kv": torch.log(kv0).requires_grad_()}
    opt = torch.optim.Adam(list(log_g.values()), lr=lr, eps=1e-8)

    costs = []
    for it in range(iters):
        opt.zero_grad()
        c = cost(log_g)
        c.backward()
        opt.step()
        costs.append(c.detach())
        if echo and it % 30 == 0:
            print(f"  grad-tune iter {it:4d} cost {float(costs[-1]):.4f}")
    kp, kv = torch.exp(log_g["kp"].detach()), torch.exp(log_g["kv"].detach())
    costs = torch.stack(costs)

    if echo:
        t = np.arange(steps) * sim_dt(params)
        for name, p_gain, v_gain in [("catalog", kp0, kv0), ("tuned", kp, kv)]:
            with torch.no_grad():
                z = response(p_gain, v_gain)[:, :, 2].mean(dim=1).cpu().numpy()
            m = step_response_metrics(t, z, 1.0)
            print(f"  {name:8s} K_pos {p_gain.cpu().numpy().round(2)} "
                  f"K_vel {v_gain.cpu().numpy().round(2)} | z-step rise "
                  f"{m['rise_time']:.3f}s overshoot {m['overshoot_pct']:.1f}% "
                  f"settle {m['settling_time']:.3f}s sse "
                  f"{m['steady_state_error']:.4f}")
        c0, c = float(costs[0]), float(costs[-1])   # costs[0]: at the catalog gains
        print(f"  cost {c0:.4f} -> {c:.4f} ({c0 / max(c, 1e-9):.1f}x)")
    return kp, kv, costs


def build_parser():
    p = argparse.ArgumentParser(description="step-response metrics of the Lee controllers")
    p.add_argument("--robot", default="base_quadrotor")
    p.add_argument("--num_envs", type=int, default=256)
    p.add_argument("--steps", type=int, default=400)
    p.add_argument("--grad", action="store_true",
                   help="gradient-descend the position / velocity gains through "
                        "the differentiable rollout before measuring")
    p.add_argument("--grad_iters", type=int, default=150)
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the default is CUDA, which must be available)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device("cpu" if args.cpu else None)
    if args.grad:
        print(f"gradient gain tuning ({args.robot}):")
        grad_tune(args.robot, iters=args.grad_iters, device=device)
        print()

    print(f"robot={args.robot}  envs={args.num_envs}  ({args.steps} steps)")
    results = {}
    for controller, axis, target, label in CASES:
        t, y = run_axis(controller, axis, target, args.steps, args.num_envs, args.robot,
                        device)
        m = step_response_metrics(t, y, target)
        results[label] = m
        print(f"{label:28s} rise {m['rise_time']:6.3f}s  "
              f"overshoot {m['overshoot_pct']:5.1f}%  "
              f"settle {m['settling_time']:6.3f}s  "
              f"sse {m['steady_state_error']:.4f}")
    return results


if __name__ == "__main__":
    main()
