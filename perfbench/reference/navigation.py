"""Plain reference of the parts of one navigation-task step that the
benchmark compares: the random draws the step takes from its generator, the
action transform, and the perception latents.

Written from the port's ``tasks/navigation_task.py`` as the benchmark found
it (``sample_nav_draws`` 137-141, ``action_transform`` 144-153, the order of
the draws in ``nav_step`` 251-262) and ``models/vae.sample_latent``. The
draw order is: (N, 9) uniform (goal and euler jitter, fresh targets), (N,
latent) normal (latent noise), then one (N, 7) uniform per physics substep
when the robot has random wrenches. Imports nothing of the port.
"""

from __future__ import annotations

import torch


def replay_draws(gen_state, device, num_envs: int, latent_dim: int, substeps: int,
                 disturbance: bool):
    """The step's draws from a copy of its generator at ``gen_state`` ->
    (uniform (N, 9), latent noise (N, latent), [per-substep (N, 7)])."""
    g = torch.Generator(device=device)
    g.set_state(gen_state)
    u = torch.rand((num_envs, 9), generator=g, device=device)
    noise = torch.randn((num_envs, latent_dim), generator=g, device=device)
    dist = [torch.rand((num_envs, 7), generator=g, device=device)
            for _ in range(substeps if disturbance else 0)]
    return u, noise, dist


def action_transform(task: dict, raw):
    """Policy output in [-1, 1]^4 -> [vx, 0, vz, yaw_rate] command."""
    a = torch.clamp(raw, -1.0, 1.0)
    a0 = a[..., 0] + 1.0
    incl, speed = task["max_inclination_angle"], task["max_speed"]
    vx = a0 * torch.cos(incl * a[..., 1]) * speed / 2.0
    vz = a0 * torch.sin(incl * a[..., 1]) * speed / 2.0
    return torch.stack([vx, torch.zeros_like(vx), vz, a[..., 2] * task["max_yawrate"]], dim=-1)


def sampled_latent(mean, logvar, noise):
    return mean + torch.exp(0.5 * logvar) * noise
