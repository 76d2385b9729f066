"""Ray-cast camera pipeline: ray table, mount pose, render, noise, range
limits.

Counterpart of ``aerial_gym_simulator_tpu/sensors/raycast_sensor.py``, cut
to a single depth camera (no stereo, lidar or normal/RGB modes). The
render packs the scene into world-frame tables and calls
``ops/raycast_cuda.raycast``: the ray-cast kernel on the card, its plain
version for CPU tensors.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import raycast, raycast_cuda
from ..sim.params import f32
from ..sim.structs import RaySensorParams, SimParams, SimState
from ..utils.math import quat_from_euler_xyz, quat_mul, tf_apply


def camera_ray_dirs(height: int, width: int, hfov_deg: float):
    """Per-pixel unit dirs in the optical frame (z forward) via K^-1, and
    the depth multiplier dot(rd, principal); numpy f32 arrays."""
    hfov = math.radians(hfov_deg)
    fx = (width / 2.0) / math.tan(hfov / 2.0)
    fy = fx
    cx, cy = width / 2.0, height / 2.0
    xs = np.arange(width, dtype=np.float32)
    ys = np.arange(height, dtype=np.float32)
    u = (xs[None, :] - cx) / fx
    v = (ys[:, None] - cy) / fy
    dirs = np.stack([
        np.broadcast_to(u, (height, width)),
        np.broadcast_to(v, (height, width)),
        np.ones((height, width), np.float32),
    ], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mult = dirs @ np.array([0.0, 0.0, 1.0], np.float32)
    return dirs.astype(np.float32), mult.astype(np.float32)


def build_ray_sensor_params(cfg, device) -> RaySensorParams:
    """Compile a camera config into device params."""
    if cfg.sensor_type != "camera":
        raise NotImplementedError(f"sensor type {cfg.sensor_type!r} is not ported yet")
    dirs, mult = camera_ray_dirs(cfg.height, cfg.width, cfg.horizontal_fov_deg)
    if not cfg.calculate_depth:
        mult = np.ones_like(mult)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)
    rot = t(np.radians(cfg.euler_frame_rot_deg))
    noise = cfg.sensor_noise
    return RaySensorParams(
        dirs=t(dirs),
        depth_multiplier=t(mult),
        data_frame_quat=quat_from_euler_xyz(rot[0], rot[1], rot[2]),
        max_range=f32(cfg.max_range),
        min_range=f32(cfg.min_range),
        far_out_value=f32(cfg.far_out_of_range_value),
        near_out_value=f32(cfg.near_out_of_range_value),
        min_translation=t(cfg.min_translation),
        max_translation=t(cfg.max_translation),
        min_rotation=t(np.radians(cfg.min_euler_rotation_deg)),
        max_rotation=t(np.radians(cfg.max_euler_rotation_deg)),
        nominal_position=t(cfg.nominal_position),
        nominal_rotation=t(np.radians(cfg.nominal_orientation_euler_deg)),
        std_a=f32(noise.std_a), std_b=f32(noise.std_b), std_c=f32(noise.std_c),
        mean_offset=f32(noise.mean_offset),
        pixel_dropout_prob=f32(noise.pixel_dropout_prob),
        height=cfg.height, width=cfg.width,
        sensor_type=cfg.sensor_type,
        calculate_depth=cfg.calculate_depth,
        return_pointcloud=cfg.return_pointcloud,
        pointcloud_in_world_frame=cfg.pointcloud_in_world_frame,
        segmentation_camera=cfg.segmentation_camera,
        normalize_range=cfg.normalize_range,
        enable_noise=noise.enable_sensor_noise,
        randomize_placement=cfg.randomize_placement,
        stereo_baseline=float(cfg.stereo_baseline),
        num_sensors=int(cfg.num_sensors),
    )


def sample_mount_pose(sp: RaySensorParams, gen: torch.Generator, num_envs: int):
    """Per-env local mount pose (N, 3), (N, 4): uniform in the configured
    ranges, or the nominal pose when placement is not randomized."""
    if sp.num_sensors != 1:
        raise NotImplementedError("multi-sensor mounts are not ported yet")
    dev = sp.dirs.device
    if sp.randomize_placement:
        u = torch.rand((num_envs, 6), generator=gen, device=dev)
        pos = sp.min_translation + (sp.max_translation - sp.min_translation) * u[:, :3]
        eul = sp.min_rotation + (sp.max_rotation - sp.min_rotation) * u[:, 3:]
    else:
        pos = sp.nominal_position.expand(num_envs, 3).clone()
        eul = sp.nominal_rotation.expand(num_envs, 3)
    return pos, quat_from_euler_xyz(eul[..., 0], eul[..., 1], eul[..., 2])


def sensor_world_pose(sp: RaySensorParams, state: SimState, mount_pos, mount_quat):
    """Compose the robot pose with the mount and data-frame rotation."""
    pos = tf_apply(state.quat, state.pos, mount_pos)
    quat = quat_mul(state.quat, quat_mul(mount_quat, sp.data_frame_quat))
    return pos, quat


def render(params: SimParams, state: SimState, sp: RaySensorParams, mount_pos,
           mount_quat, gen: torch.Generator = None, want_seg=None):
    """Sensor capture -> (pixels (N, H, W), segmentation (N, H, W) int32 or
    None). want_seg None follows sp.segmentation_camera; False skips the
    segmentation work (depth-only consumers). ``gen`` draws the sensor
    noise when the config enables it."""
    if sp.return_pointcloud or sp.stereo_baseline > 0.0:
        raise NotImplementedError("pointcloud and stereo capture are not ported yet")
    if want_seg is None:
        want_seg = bool(sp.segmentation_camera)
    N = state.pos.shape[0]
    H, W = sp.height, sp.width
    R = H * W
    sc = params.scene
    mult = sp.depth_multiplier.reshape(R)
    if sc is None or sc.num_env_prims == 0:
        depth = (raycast.NO_HIT_RAY_VAL * mult).expand(N, R).clone()
        seg = torch.full((N, R), raycast.NO_HIT_SEGMENTATION_VAL, dtype=torch.int32,
                         device=depth.device) if want_seg else None
    else:
        pos_w, quat_w = sensor_world_pose(sp, state, mount_pos, mount_quat)
        prims = raycast_cuda.pack_prims_world(sc, state.obstacle_pos, state.obstacle_quat)
        depth, seg = raycast_cuda.raycast(
            raycast_cuda.pack_pose(pos_w, quat_w), prims, sp.dirs.reshape(R, 3),
            mult, sc.n_box, sc.n_cyl, sc.n_sph, sp.max_range, want_seg=want_seg,
            n_tri=sc.n_tri)
    pixels = depth.reshape(N, H, W)
    if sp.enable_noise and gen is not None:
        pixels = apply_noise(sp, pixels, gen)
    pixels = apply_range_limits(sp, pixels)
    if sp.normalize_range:
        pixels = pixels / sp.max_range
    return pixels, (seg.reshape(N, H, W) if want_seg else None)


def apply_noise(sp: RaySensorParams, pixels, gen: torch.Generator):
    """std = a*x^2 + b*x + c gaussian + pixel dropout."""
    std = sp.std_a * pixels ** 2 + sp.std_b * pixels + sp.std_c
    noise = torch.randn(pixels.shape, generator=gen, device=pixels.device)
    pixels = pixels - sp.mean_offset + std * noise
    drop = torch.rand(pixels.shape, generator=gen, device=pixels.device) < sp.pixel_dropout_prob
    return torch.where(drop, torch.full_like(pixels, sp.near_out_value), pixels)


def apply_range_limits(sp: RaySensorParams, pixels):
    pixels = torch.where(pixels > sp.max_range, torch.full_like(pixels, sp.far_out_value),
                         pixels)
    return torch.where(pixels < sp.min_range, torch.full_like(pixels, sp.near_out_value),
                       pixels)


def render_camera(params: SimParams, state: SimState, gen: torch.Generator = None,
                  want_seg=None):
    return render(params, state, params.camera, state.cam_mount_pos,
                  state.cam_mount_quat, gen, want_seg=want_seg)
