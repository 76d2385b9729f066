"""Kind ``navigation_policy``: a shipped policy flies the navigation task
closed loop, ``task.step(policy(obs))``, the way users evaluate a trained
navigation policy; the task resets its own episodes.

The configuration names the registered task, the shipped encoder pickle and
the shipped policy archive. To judge the depth image the task renders inside
its step (and keeps no copy of), this kind wraps the navigation task
module's ``render_camera`` for the life of the loop, and keeps the image
only at a capture step.

Compared at each capture step: the policy's actions from the observation it
read, the physics step from the state before it and the program's action
(the task's disturbance and latent-noise draws replayed from the generator's
state), the crash verdicts, the depth image of the compared envs against the
reference's render of the state rendered, and the encoder's sampled latents
against the reference encoder on the reference's own render.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import torch

from ..counts import attention as att
from ..counts import raycast as rc
from ..counts import vit as vc
from ..counts.peaks import PEAK_BF16_FLOPS
from ..harness import checks
from ..harness.port import (attention_launches, port_seed, raycast_launches, scene_tables,
                            small_camera, state_dict)
from ..reference import navigation as nav_ref
from ..reference.networks import PolicyReference, ViTReference
from ..reference.physics import Physics, env_step
from ..reference.raycast import Camera, prim_counts, render, sensor_pose, world_prims

ROOT = Path(__file__).resolve().parents[2]
# the observation's layout: 17 task numbers, then the latents
LATENTS_AT = 17


class Loop:
    def __init__(self, cfg, traffic, device, seed, overrides):
        import aerial_gym_simulator_tpu_torch as port
        import aerial_gym_simulator_tpu_torch.tasks.navigation_task as nav
        from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
        self.cfg = cfg
        self.num_envs = int(overrides.get("envs", traffic["envs"]))
        self.work = {"env_steps": self.num_envs}
        task_cfg = dataclasses.replace(port.task_registry.get_task_config(cfg["task"]),
                                       vae_params_path=str(ROOT / cfg["encoder"]))
        self.task = port.task_registry.make_task(cfg["task"], num_envs=self.num_envs,
                                                 seed=port_seed(seed), task_config=task_cfg,
                                                 device=str(device))
        if "camera_hw" in overrides:
            self.task.params = small_camera(self.task.params, overrides["camera_hw"], device)
            self.task.sim_env.params = self.task.params
        self.policy = load_policy_npz(str(ROOT / cfg["policy"]), device=str(device))
        self.obs = self.task.reset()[0]["observations"]
        self.scene = scene_tables(self.task.params.scene)
        self._pixels = None
        self._want_pixels = False
        self._nav = nav
        self._render = nav.render_camera

        def render_camera(*args, **kwargs):
            out = self._render(*args, **kwargs)
            if self._want_pixels:
                self._pixels = out[0]
            return out

        nav.render_camera = render_camera

    def libraries(self):
        from aerial_gym_simulator_tpu_torch.ops import attention_cuda, raycast_cuda
        return [raycast_cuda.LIBRARY, attention_cuda.LIBRARY]

    def launches(self):
        return {**raycast_launches(), **attention_launches()}

    def step(self, i, spans, cap=None):
        task = self.task
        if cap is not None:
            ns = task.nav_state
            cap.update(before=state_dict(ns.sim), obs=self.obs, rng=ns.sim.rng.get_state())
            self._want_pixels = True
        with spans("policy"):
            action = self.policy(self.obs)
        with spans("task_step"):
            obs_dict, _, term, trunc, _ = task.step(action)
        self.obs = obs_dict["observations"]
        if cap is not None:
            self._want_pixels = False
            rows = cap["rows"]
            cap.update(action=action, after=state_dict(task.nav_state.sim), obs_after=self.obs,
                       term=term, trunc=trunc, depth=self._pixels.index_select(0, rows))
            self._pixels = None

    def bound_inputs(self):
        return state_dict(self.task.nav_state.sim)

    def bounds(self, state, device):
        """Least time of the step's counted work (seconds): the ray cast's
        on the render's poses and tables, the attention kernel's per launch,
        and the encoder's and policy's products at the bf16 peak."""
        cam = Camera(self.cfg["camera"], device)
        with torch.no_grad():
            origin, quat = sensor_pose(cam, state["pos"], state["quat"], state["cam_mount_pos"],
                                       state["cam_mount_quat"])
            prims = world_prims(self.scene, state["obstacle_pos"], state["obstacle_quat"])
            pose = torch.cat([origin, quat, torch.zeros_like(origin[:, :1])], dim=-1)
            ray_s, by, _ = rc.least_time_s(pose, prims, cam.dirs, prim_counts(self.scene),
                                           cam.max_range, "depth")
        enc, n = self.cfg["encoder_shape"], self.num_envs
        flops = (vc.vit_flops_per_image(enc["tokens"], enc["patch"][0] * enc["patch"][1],
                                        enc["dim"], enc["depth"], enc["latent_dim"])
                 + vc.mlp_flops(self.cfg["policy_widths"]))
        return dict(raycast_s=ray_s, raycast_by=by,
                    attention_s=att.attention_bound_s(n, enc["tokens"], enc["dim"], enc["heads"], 2),
                    counted_s=ray_s + n * flops / PEAK_BF16_FLOPS)

    def close(self):
        """Restores the task module, frees the program, returns what the
        check keeps of its set-up."""
        self._nav.render_camera = self._render
        kept = dict(scene=self.scene)
        self.task = self.policy = self.obs = self.scene = None
        return kept


class Check:
    def __init__(self, cfg, traffic, device, overrides, kept):
        self.cfg, self.device, self.scene = cfg, device, kept["scene"]
        self.cam_cfg = dict(cfg["camera"])
        if "camera_hw" in overrides:
            self.cam_cfg.update(height=overrides["camera_hw"][0], width=overrides["camera_hw"][1])
        self.vit = ViTReference(str(ROOT / cfg["encoder"]), device)
        self.policy = PolicyReference(str(ROOT / cfg["policy"]), device)

    def program(self, cap):
        lat = self.cfg["task_params"]["latent_dim"]
        return dict(action=cap["action"], stepped=dict(cap["after"], crashes=cap["term"]),
                    depth=cap["depth"],
                    latents=cap["obs_after"].index_select(0, cap["rows"])[:, LATENTS_AT:LATENTS_AT + lat])

    def reference(self, cap, precision=None):
        """At the configuration's precision (float32 physics, ray cast and
        policy, float32 networks for the bf16 encoder), or with
        ``precision`` "control" at the next below: bfloat16 physics, ray
        cast and policy, float8 e4m3 encoder products."""
        control = precision == "control"
        dt = torch.bfloat16 if control else torch.float32
        ph = Physics.build(self.cfg["physics"], self.device, dt)
        task, rows = self.cfg["task_params"], cap["rows"]
        n = cap["obs"].shape[0]
        out = dict(action=self.policy(cap["obs"], quant="bf16" if control else None))
        u, noise, dist = nav_ref.replay_draws(cap["rng"], self.device, n, task["latent_dim"],
                                              ph.substeps, ph.disturbance)
        command = nav_ref.action_transform(task, cap["action"])
        out["stepped"] = env_step(ph, cap["before"], command, self.scene, disturbances=dist,
                                  dtype=dt)
        depth, _ = render(Camera(self.cam_cfg, self.device, dt), checks.rows(self.scene, rows),
                          checks.rows(cap["after"], rows), want_seg=False)
        out["depth"] = depth
        mean, logvar = self.vit.moments(depth, quant="fp8" if control else None,
                                        image_hw=(self.cfg["camera"]["height"],
                                                  self.cfg["camera"]["width"]))
        out["latents"] = nav_ref.sampled_latent(mean, logvar, noise.index_select(0, rows))
        return out

    def compare(self, got, ref, cap):
        # the task resets its done envs with fresh draws: their state is
        # compared only up to the verdict
        keep = (cap["term"] <= 0) & (cap["trunc"] <= 0)
        g, r = got["stepped"], ref["stepped"]
        return dict(state_gap=checks.state_gap(g, r, keep),
                    crash_mismatch=checks.count_unequal(g["crashes"], r["crashes"]),
                    depth_mismatch_share=checks.depth_mismatch_share(got["depth"], ref["depth"]),
                    action_gap=checks.max_gap_over_rms(got["action"], ref["action"]),
                    latent_rel_err=checks.rms_gap_over_rms(got["latents"], ref["latents"]))
