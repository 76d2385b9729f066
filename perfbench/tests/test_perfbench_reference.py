"""The frozen yardstick against the port's CPU path at a tiny size: the
physics step, the camera render, the ViT encoder and the policy, and the
ray cast's broad-phase count."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
OBSTACLE = json.loads((ROOT / "perfbench/configs/obstacle_camera.json").read_text())
NAV = json.loads((ROOT / "perfbench/configs/nav_vit.json").read_text())
SMALL = (27, 48)


def _env(cfg, n=4, seed=3):
    from perfbench.harness.port import small_camera
    from aerial_gym_simulator_tpu_torch.sim.sim_builder import SimBuilder
    b = cfg["build"] if "build" in cfg else dict(sim="base_sim", env="env_with_obstacles",
                                                  robot="lmf2", controller="lmf2_velocity_control")
    env = SimBuilder().build_env(b["sim"], b["env"], b["robot"], b["controller"], device="cpu",
                                 num_envs=n, seed=seed)
    env.params = small_camera(env.params, SMALL, "cpu")
    return env


@pytest.mark.parametrize("cfg", [OBSTACLE, NAV], ids=["obstacle_camera", "nav_vit"])
def test_physics_step_matches_port(cfg):
    from perfbench.harness.port import scene_tables, state_dict
    from perfbench.reference.physics import Physics, env_step
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    env = _env(cfg)
    g = torch.Generator().manual_seed(1)
    for _ in range(3):
        a = 4.0 * torch.rand((4, 4), generator=g) - 2.0
        before = state_dict(env.state)
        gen_state = env.state.rng.get_state()
        after = dynamics.env_step(env.params, env.state, a)
        ph = Physics.build(cfg["physics"], "cpu")
        dist = None
        if ph.disturbance:
            gg = torch.Generator().manual_seed(0)
            gg.set_state(gen_state)
            dist = [torch.rand((4, 7), generator=gg) for _ in range(ph.substeps)]
        ref = env_step(ph, before, a, scene_tables(env.params.scene), disturbances=dist)
        for k in ("pos", "quat", "linvel", "angvel", "motor_thrust", "crashes"):
            assert torch.equal(getattr(after, k), ref[k]), k
        env.state = after


def test_render_matches_port():
    from perfbench.harness.port import scene_tables, state_dict
    from perfbench.reference.raycast import Camera, render
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import render_camera
    env = _env(OBSTACLE)
    env.step(torch.zeros(4, 4))
    depth, seg = render_camera(env.params, env.state)
    cam = dict(OBSTACLE["camera"], height=SMALL[0], width=SMALL[1])
    ref_d, ref_s = render(Camera(cam, "cpu"), scene_tables(env.params.scene),
                          state_dict(env.state))
    # the reference composes the primitives' rotations elementwise: a few
    # rays at a silhouette may flip
    assert float(((depth - ref_d).abs() > 1e-4).float().mean()) < 1e-3
    assert float((seg != ref_s).float().mean()) < 1e-3
    assert float((depth - ref_d).abs().median()) == 0.0


def test_encoder_and_policy_match_port():
    from perfbench.reference.networks import PolicyReference, ViTReference
    from aerial_gym_simulator_tpu_torch.sim.convert import load_encoder_pickle
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
    _, enc = load_encoder_pickle(str(ROOT / NAV["encoder"]))
    for blk in enc.blocks:
        blk.attn.impl = "reference"
    g = torch.Generator().manual_seed(2)
    images = torch.rand((2, 135, 240), generator=g)
    with torch.no_grad():
        mean, logvar = enc(images[..., None])
    ref = ViTReference(str(ROOT / NAV["encoder"]), "cpu")
    r_mean, r_logvar = ref.moments(images)
    assert torch.allclose(mean, r_mean, atol=1e-4, rtol=1e-4)
    assert torch.allclose(logvar, r_logvar, atol=1e-4, rtol=1e-4)
    policy = load_policy_npz(str(ROOT / NAV["policy"]), device="cpu")
    obs = torch.randn((8, 81), generator=g)
    assert torch.allclose(policy(obs), PolicyReference(str(ROOT / NAV["policy"]), "cpu")(obs),
                          atol=1e-6, rtol=1e-6)


def test_broad_phase_count_matches_port():
    from perfbench.counts import raycast as rc
    from perfbench.harness.port import scene_tables, state_dict
    from perfbench.reference.raycast import Camera, prim_counts, sensor_pose, world_prims
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda
    env = _env(OBSTACLE)
    st, sc = state_dict(env.state), scene_tables(env.params.scene)
    cam = Camera(dict(OBSTACLE["camera"], height=SMALL[0], width=SMALL[1]), "cpu")
    origin, quat = sensor_pose(cam, st["pos"], st["quat"], st["cam_mount_pos"],
                               st["cam_mount_quat"])
    pose = torch.cat([origin, quat, torch.zeros_like(origin[:, :1])], dim=-1)
    prims = world_prims(sc, st["obstacle_pos"], st["obstacle_quat"])
    counts = prim_counts(sc)
    ours = rc.sphere_hits(pose, prims, cam.dirs, rc.kinds_of(counts, "cpu"), cam.max_range)
    theirs = raycast_cuda.bounding_sphere_hits(pose, prims, cam.dirs, *counts[:3], cam.max_range)
    assert torch.equal(ours, theirs)
    assert float(ours.sum()) > 0


def test_counted_operations():
    from perfbench.counts import attention, vit
    per_image = vit.vit_flops_per_image(225, 144, 256, 4, 64)
    assert 1.6e9 < per_image < 1.7e9
    assert vit.mlp_flops([81, 256, 128, 64, 4]) == 2.0 * (81 * 256 + 256 * 128 + 128 * 64 + 64 * 4)
    # the serving shape is bound by its bytes (chip_smoke's 0.141 ms at 1,024 envs)
    assert abs(attention.attention_bound_s(1024, 225, 256, 8, 2) * 1e3 - 0.1408) < 1e-3
    assert np.isfinite(attention.attention_bound_s(64, 225, 256, 8, 4))
