"""Ray-cast sensor pipeline: camera and lidar ray tables, mount pose,
render, noise, range limits, and the normal/face-id and RGB captures.

Counterpart of ``aerial_gym_simulator_tpu/sensors/raycast_sensor.py``. A
sensor config with ``num_sensors`` S > 1 gets S mounts per robot, each
drawn on its own, and every capture stacks the S images on axis 1. A stereo
camera (``stereo_baseline`` > 0) casts a second, depth-only eye and keeps
the farther hit of the two. A sensor whose config asks for a pointcloud
returns the hit points, in the sensor frame or in the world frame. Every
capture packs the scene into world-frame tables
and calls ``ops/raycast_cuda.raycast`` with the sensor's (H, W) ray grid:
the ray-cast kernel on the card, which tiles the grid in 2-D, its plain
version for CPU tensors. Outputs are in row-major ray order. Each capture
is the span ``render`` (``utils/profiling.span``), its mounts and stereo
eye included.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..ops import raycast, raycast_cuda
from ..ops.raycast import shade_rgb
from ..sim.params import f32
from ..sim.structs import RaySensorParams, SimParams, SimState
from ..utils.env_rng import env_rand, env_randn
from ..utils.math import quat_from_euler_xyz, quat_mul, quat_rotate, tf_apply
from ..utils.profiling import spanned


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


def lidar_ray_dirs(height: int, width: int, h_min: float, h_max: float,
                   v_min: float, v_max: float):
    """Spherical azimuth/elevation table in the sensor frame (x forward),
    in the reference's scan order (+HFOV -> -HFOV, +VFOV -> -VFOV), and
    a multiplier of ones (a lidar returns range); numpy f32 arrays."""
    h_min, h_max = math.radians(h_min), math.radians(h_max)
    v_min, v_max = math.radians(v_min), math.radians(v_max)
    j = np.arange(width, dtype=np.float32)
    i = np.arange(height, dtype=np.float32)
    az = h_max - (h_max - h_min) * (j / max(width - 1, 1))
    el = v_max - (v_max - v_min) * (i / max(height - 1, 1))
    azg = np.broadcast_to(az[None, :], (height, width))
    elg = np.broadcast_to(el[:, None], (height, width))
    dirs = np.stack([np.cos(azg) * np.cos(elg), np.sin(azg) * np.cos(elg), np.sin(elg)],
                    axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    return dirs.astype(np.float32), np.ones((height, width), np.float32)


def build_ray_sensor_params(cfg, device) -> RaySensorParams:
    """Compile a camera or lidar config into device params."""
    if cfg.sensor_type == "camera":
        dirs, mult = camera_ray_dirs(cfg.height, cfg.width, cfg.horizontal_fov_deg)
        if not cfg.calculate_depth:
            mult = np.ones_like(mult)
    else:
        dirs, mult = lidar_ray_dirs(cfg.height, cfg.width, cfg.horizontal_fov_deg_min,
                                    cfg.horizontal_fov_deg_max, cfg.vertical_fov_deg_min,
                                    cfg.vertical_fov_deg_max)
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
    ranges, or the nominal pose when placement is not randomized. With
    ``num_sensors`` S > 1, (N, S, 3), (N, S, 4): one mount per copy, drawn
    copy after copy."""
    if sp.num_sensors > 1:
        poses, quats = zip(*(_one_mount(sp, gen, num_envs) for _ in range(sp.num_sensors)))
        return torch.stack(poses, dim=1), torch.stack(quats, dim=1)
    return _one_mount(sp, gen, num_envs)


def _one_mount(sp: RaySensorParams, gen: torch.Generator, num_envs: int):
    dev = sp.dirs.device
    if sp.randomize_placement:
        u = env_rand(gen, (num_envs, 6), device=dev)
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


def cast_inputs(params: SimParams, state: SimState, sp: RaySensorParams, mount_pos,
                mount_quat):
    """The ray-cast kernel's inputs for one mount, as every capture packs
    them: (pose, prims, dirs, mult, n_box, n_cyl, n_sph, max_range), with
    the sensor's ray grid as it is, dirs (H, W, 3) and mult (H, W), so that
    the kernel tiles it in 2-D."""
    pos_w, quat_w = sensor_world_pose(sp, state, mount_pos, mount_quat)
    return _pack(params, state, sp, pos_w, quat_w, sp.depth_multiplier)


def _pack(params, state, sp, pos_w, quat_w, mult):
    sc = params.scene
    return (raycast_cuda.pack_pose(pos_w, quat_w),
            raycast_cuda.pack_prims_world(sc, state.obstacle_pos, state.obstacle_quat),
            sp.dirs, mult, sc.n_box, sc.n_cyl, sc.n_sph, sp.max_range)


def right_eye_origin(sp: RaySensorParams, pos_w, quat_w):
    """A stereo sensor's right eye: the left eye's world origin moved by
    ``stereo_baseline`` along the sensor frame's -x, rotated by the world
    quaternion (its data-frame part included), as in the JAX package."""
    baseline = torch.tensor([-sp.stereo_baseline, 0.0, 0.0], device=pos_w.device)
    return pos_w + quat_rotate(quat_w, baseline.expand(pos_w.shape[0], 3))


@spanned("render")
def render(params: SimParams, state: SimState, sp: RaySensorParams, mount_pos,
           mount_quat, gen: torch.Generator = None, want_seg=None):
    """Sensor capture -> (pixels, segmentation (N, H, W) int32 or None).
    pixels is the (N, H, W) depth/range image, or the (N, H, W, 3)
    pointcloud when sp.return_pointcloud: the hit points in the world frame
    (sp.pointcloud_in_world_frame) or the sensor frame, a miss at the
    no-hit range along its ray. want_seg None follows
    sp.segmentation_camera; False skips the segmentation work (depth-only
    consumers). ``gen`` draws the sensor noise when the config enables it.
    Noise, then range limits and normalization, except on a world-frame
    pointcloud, which gets the noise only.

    Mounts (N, S, 3)/(N, S, 4) capture each of the S sensors and stack the
    outputs on axis 1: (N, S, H, W[, 3]). A stereo sensor's right eye sits
    ``stereo_baseline`` along the sensor frame's -x of the left eye (the
    world quaternion rotates the offset, its data-frame part included); it
    is cast in depth-only mode and each pixel keeps the farther of the two
    eyes' hits. The segmentation is the left eye's."""
    if mount_pos.dim() == 3:
        pixels, segs = zip(*(render(params, state, sp, mount_pos[:, k], mount_quat[:, k], gen,
                                    want_seg=want_seg)
                             for k in range(mount_pos.shape[1])))
        return (torch.stack(pixels, dim=1),
                torch.stack(segs, dim=1) if segs[0] is not None else None)
    if want_seg is None:
        want_seg = bool(sp.segmentation_camera)
    N = state.pos.shape[0]
    H, W = sp.height, sp.width
    R = H * W
    sc = params.scene
    # a pointcloud needs the range along each ray: a unit multiplier
    mult = torch.ones_like(sp.depth_multiplier) if sp.return_pointcloud else sp.depth_multiplier
    pos_w, quat_w = sensor_world_pose(sp, state, mount_pos, mount_quat)
    if sc is None or sc.num_env_prims == 0:
        depth = (raycast.NO_HIT_RAY_VAL * mult.reshape(R)).expand(N, R).clone()
        seg = torch.full((N, R), raycast.NO_HIT_SEGMENTATION_VAL, dtype=torch.int32,
                         device=depth.device) if want_seg else None
    else:
        args = _pack(params, state, sp, pos_w, quat_w, mult)
        depth, seg = raycast_cuda.raycast(*args, want_seg=want_seg, n_tri=sc.n_tri)
        if sp.stereo_baseline > 0.0:
            right = raycast_cuda.pack_pose(right_eye_origin(sp, pos_w, quat_w), quat_w)
            depth_r, _ = raycast_cuda.raycast(right, *args[1:], want_seg=False, n_tri=sc.n_tri)
            # each eye's depth is t * mult, the multiplier applied per eye
            # (in the kernel); the JAX package multiplies after the max. The
            # multiplier is positive and f32 rounding monotonic, so
            # max(m t_l, m t_r) == m max(t_l, t_r) bit for bit
            depth = torch.maximum(depth, depth_r)
    if sp.return_pointcloud:
        dirs = sp.dirs.reshape(R, 3)
        if sp.pointcloud_in_world_frame:
            rd_world = quat_rotate(quat_w[:, None, :], dirs[None, :, :])
            pts = pos_w[:, None, :] + depth[..., None] * rd_world
        else:
            pts = depth[..., None] * dirs[None, :, :]
        pixels = pts.reshape(N, H, W, 3)
    else:
        pixels = depth.reshape(N, H, W)
    if sp.enable_noise and gen is not None:
        pixels = apply_noise(sp, pixels, gen)
    if not (sp.return_pointcloud and sp.pointcloud_in_world_frame):
        pixels = apply_range_limits(sp, pixels)
        if sp.normalize_range:
            pixels = pixels / sp.max_range
    return pixels, (seg.reshape(N, H, W) if want_seg else None)


def apply_noise(sp: RaySensorParams, pixels, gen: torch.Generator):
    """std = a*x^2 + b*x + c gaussian + pixel dropout."""
    std = sp.std_a * pixels ** 2 + sp.std_b * pixels + sp.std_c
    noise = env_randn(gen, pixels.shape, device=pixels.device)
    pixels = pixels - sp.mean_offset + std * noise
    drop = env_rand(gen, pixels.shape, device=pixels.device) < sp.pixel_dropout_prob
    return torch.where(drop, torch.full_like(pixels, sp.near_out_value), pixels)


def apply_range_limits(sp: RaySensorParams, pixels):
    """Out-of-range sentinels; a sensor-frame pointcloud (N, H, W, 3) is
    limited by each point's norm."""
    if pixels.dim() == 4:
        r = torch.linalg.norm(pixels, dim=-1, keepdim=True)
        pixels = torch.where(r > sp.max_range, torch.full_like(pixels, sp.far_out_value),
                             pixels)
        return torch.where(r < sp.min_range, torch.full_like(pixels, sp.near_out_value),
                           pixels)
    pixels = torch.where(pixels > sp.max_range, torch.full_like(pixels, sp.far_out_value),
                         pixels)
    return torch.where(pixels < sp.min_range, torch.full_like(pixels, sp.near_out_value),
                       pixels)


def _stacked(fn, params, state, sp, mount_pos, mount_quat):
    """Mounts (N, S, 3)/(N, S, 4): capture each and stack on axis 1."""
    outs = [fn(params, state, sp, mount_pos[:, k], mount_quat[:, k])
            for k in range(mount_pos.shape[1])]
    return tuple(torch.stack(parts, dim=1) for parts in zip(*outs))


@spanned("render")
def render_normal_faceid(params: SimParams, state: SimState, sp: RaySensorParams,
                         mount_pos, mount_quat):
    """Normal + face-id capture (the reference's NormalFaceID cameras and
    lidars): per-pixel world surface normal oriented against the ray and
    the hit primitive's index, with depth/range and segmentation. No noise,
    range limits or normalization.

    Returns (depth (N,H,W), normals (N,H,W,3), face_id (N,H,W) int32, seg
    (N,H,W) int32): depth NO_HIT_RAY_VAL, normal 0, face -1 and seg -2
    where nothing was hit; with mounts (N, S, ...) every output gains the
    sensor axis at position 1."""
    if mount_pos.dim() == 3:
        return _stacked(render_normal_faceid, params, state, sp, mount_pos, mount_quat)
    N, H, W = state.pos.shape[0], sp.height, sp.width
    sc = params.scene
    dev = state.pos.device
    if sc is None or sc.num_env_prims == 0:
        return (torch.full((N, H, W), raycast.NO_HIT_RAY_VAL, device=dev),
                torch.zeros((N, H, W, 3), device=dev),
                torch.full((N, H, W), raycast.NO_HIT_FACE_VAL, dtype=torch.int32, device=dev),
                torch.full((N, H, W), raycast.NO_HIT_SEGMENTATION_VAL, dtype=torch.int32,
                           device=dev))
    depth, seg, normals, face = raycast_cuda.raycast(
        *cast_inputs(params, state, sp, mount_pos, mount_quat), n_tri=sc.n_tri,
        want_normals=True)
    depth = torch.where(face >= 0, depth, torch.full_like(depth, raycast.NO_HIT_RAY_VAL))
    return (depth.reshape(N, H, W), normals.reshape(N, H, W, 3), face.reshape(N, H, W),
            seg.reshape(N, H, W))


@spanned("render")
def render_rgb(params: SimParams, state: SimState, sp: RaySensorParams, mount_pos,
               mount_quat):
    """Onboard RGB capture: the Lambert shade (``shade_rgb``) of the ray-cast
    render. On the card one launch of the kernel's RGB mode; on the CPU
    render_normal_faceid + shade_rgb, which evaluate the same expressions.

    Returns (rgb (N,H,W,3) f32 in [0, 1], depth (N,H,W), seg (N,H,W));
    with mounts (N, S, ...) every output gains the sensor axis at
    position 1."""
    if mount_pos.dim() == 3:
        return _stacked(render_rgb, params, state, sp, mount_pos, mount_quat)
    sc = params.scene
    if state.pos.device.type == "cuda" and sc is not None and sc.num_env_prims > 0:
        N, H, W = state.pos.shape[0], sp.height, sp.width
        depth, seg, rgb = raycast_cuda.raycast(
            *cast_inputs(params, state, sp, mount_pos, mount_quat), n_tri=sc.n_tri,
            want_rgb=True)
        return rgb.reshape(N, H, W, 3), depth.reshape(N, H, W), seg.reshape(N, H, W)
    depth, normals, face, seg = render_normal_faceid(params, state, sp, mount_pos, mount_quat)
    return shade_rgb(depth, normals, face, seg, sp.max_range), depth, seg


def render_camera(params: SimParams, state: SimState, gen: torch.Generator = None,
                  want_seg=None):
    return render(params, state, params.camera, state.cam_mount_pos,
                  state.cam_mount_quat, gen, want_seg=want_seg)


def render_lidar(params: SimParams, state: SimState, gen: torch.Generator = None,
                 want_seg=None):
    return render(params, state, params.lidar, state.lidar_mount_pos,
                  state.lidar_mount_quat, gen, want_seg=want_seg)


def render_rgb_camera(params: SimParams, state: SimState):
    return render_rgb(params, state, params.camera, state.cam_mount_pos,
                      state.cam_mount_quat)


def render_normal_faceid_camera(params: SimParams, state: SimState):
    return render_normal_faceid(params, state, params.camera, state.cam_mount_pos,
                                state.cam_mount_quat)


def render_normal_faceid_lidar(params: SimParams, state: SimState):
    return render_normal_faceid(params, state, params.lidar, state.lidar_mount_pos,
                                state.lidar_mount_quat)
