"""Kind ``env_camera``: the simulator's own loop, as a vision-training run
drives it.

Each step is ``EnvManager.step(actions)`` -> ``post_reward_calculation_step()``
(crashed envs reset as in training) -> ``render()`` (depth, and segmentation
where the configuration's camera has it). Actions are drawn uniformly in
[``action_low``, ``action_high``] from the seed into a pool of
``action_pool`` batches at set-up and cycled. A traffic file of this kind
may set ``"render": false`` to step the physics alone.

Compared at each capture step: the physics step from the state and action
before it (all envs), the crash verdicts, that the reset left every env that
did not crash or time out untouched, and the compared envs' depth (and
segmentation) images against the reference's render of the state rendered.
"""

from __future__ import annotations

import torch

from ..counts import raycast as rc
from ..harness import checks
from ..harness.port import port_seed, raycast_launches, scene_tables, small_camera, state_dict
from ..reference.physics import Physics, env_step
from ..reference.raycast import Camera, prim_counts, render, sensor_pose, world_prims


def _renders(traffic):
    return bool(traffic.get("render", True))


class Loop:
    def __init__(self, cfg, traffic, device, seed, overrides):
        from aerial_gym_simulator_tpu_torch.sim.sim_builder import SimBuilder
        self.cfg, self.render = cfg, _renders(traffic)
        self.num_envs = int(overrides.get("envs", traffic["envs"]))
        self.work = {"env_steps": self.num_envs}
        b = cfg["build"]
        self.env = SimBuilder().build_env(b["sim"], b["env"], b["robot"], b["controller"],
                                          device=device, num_envs=self.num_envs,
                                          seed=port_seed(seed))
        if "camera_hw" in overrides:
            self.env.params = small_camera(self.env.params, overrides["camera_hw"], device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        lo = torch.tensor(traffic["action_low"], device=device)
        hi = torch.tensor(traffic["action_high"], device=device)
        u = torch.rand((int(traffic["action_pool"]), self.num_envs, lo.numel()), generator=gen,
                       device=device)
        self.pool = lo + (hi - lo) * u
        self.scene = scene_tables(self.env.params.scene)

    def libraries(self):
        from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
        return [raycast_cuda.LIBRARY] if self.render else []

    def launches(self):
        return raycast_launches()

    def step(self, i, spans, cap=None):
        env = self.env
        a = self.pool[i % self.pool.shape[0]]
        if cap is not None:
            cap.update(before=state_dict(env.state), action=a)
        with spans("env_step"):
            env.step(a)
        if cap is not None:
            cap["stepped"] = state_dict(env.state)
        with spans("reset"):
            env.post_reward_calculation_step()
        if self.render:
            with spans("render"):
                env.render()
        if cap is not None:
            cap["after"] = state_dict(env.state)
            if self.render:
                obs = env.get_obs()
                cap["depth"] = obs["depth_range_pixels"].index_select(0, cap["rows"])
                if self.cfg["camera"]["segmentation_camera"]:
                    cap["seg"] = obs["segmentation_pixels"].index_select(0, cap["rows"])

    def bound_inputs(self):
        """The state the next render reads."""
        return state_dict(self.env.state)

    def bounds(self, state, device):
        """Least time of the step's counted work: the ray cast's on the
        render's poses and tables (``counts/raycast.py``). Seconds."""
        if not self.render:
            return {}
        cam = Camera(self.cfg["camera"], device)
        with torch.no_grad():
            origin, quat = sensor_pose(cam, state["pos"], state["quat"], state["cam_mount_pos"],
                                       state["cam_mount_quat"])
            prims = world_prims(self.scene, state["obstacle_pos"], state["obstacle_quat"])
            pose = torch.cat([origin, quat, torch.zeros_like(origin[:, :1])], dim=-1)
            mode = "seg" if self.cfg["camera"]["segmentation_camera"] else "depth"
            ray_s, by, _ = rc.least_time_s(pose, prims, cam.dirs, prim_counts(self.scene),
                                           cam.max_range, mode)
        return dict(raycast_s=ray_s, raycast_by=by, counted_s=ray_s)

    def close(self):
        """Frees the program; returns what the check keeps of its set-up."""
        kept = dict(scene=self.scene)
        self.env = self.pool = self.scene = None
        return kept


class Check:
    """The references of one cell, rebuilt from its configuration."""

    def __init__(self, cfg, traffic, device, overrides, kept):
        self.cfg, self.device, self.scene = cfg, device, kept["scene"]
        self.render = _renders(traffic)
        self.cam_cfg = dict(cfg["camera"])
        if "camera_hw" in overrides:
            self.cam_cfg.update(height=overrides["camera_hw"][0], width=overrides["camera_hw"][1])

    def program(self, cap):
        return {k: cap[k] for k in ("stepped", "depth", "seg") if k in cap}

    def reference(self, cap, precision=None):
        """At the configuration's precision (float32), or with ``precision``
        "control" at the next below it (bfloat16)."""
        dt = torch.bfloat16 if precision == "control" else torch.float32
        ph = Physics.build(self.cfg["physics"], self.device, dt)
        out = dict(stepped=env_step(ph, cap["before"], cap["action"], self.scene, dtype=dt))
        if self.render:
            seg = bool(self.cfg["camera"]["segmentation_camera"])
            depth, s = render(Camera(self.cam_cfg, self.device, dt),
                              checks.rows(self.scene, cap["rows"]),
                              checks.rows(cap["after"], cap["rows"]), want_seg=seg)
            out["depth"] = depth
            if seg:
                out["seg"] = s
        return out

    def compare(self, got, ref, cap):
        g, r = got["stepped"], ref["stepped"]
        out = dict(state_gap=checks.state_gap(g, r, torch.ones_like(r["crashes"], dtype=torch.bool)),
                   crash_mismatch=checks.count_unequal(g["crashes"], r["crashes"]),
                   reset_kept_mismatch=_reset_kept(cap))
        if "depth" in ref:
            out["depth_mismatch_share"] = checks.depth_mismatch_share(got["depth"], ref["depth"])
        if "seg" in ref:
            out["seg_mismatch_share"] = checks.unequal_share(got["seg"], ref["seg"])
        return out


def _reset_kept(cap):
    """Envs that did not crash or time out and whose state the reset changed
    (the reset's fresh draws are its own; this is the part of the stage that
    can be judged). Read from the program's capture alone."""
    s, a = cap["stepped"], cap["after"]
    keep = (s["crashes"] <= 0) & (s["truncations"] <= 0)
    changed = torch.zeros_like(keep)
    for k in checks.STATE_COMPARED + ("obstacle_pos", "obstacle_quat"):
        changed |= (s[k] != a[k]).reshape(s[k].shape[0], -1).any(dim=1)
    return float((changed & keep).sum())
