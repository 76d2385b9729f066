"""Plain reference of the depth camera: ray grid, sensor pose, world-frame
primitive table, nearest hit of every ray against every primitive, range
limits and normalisation.

A frozen copy, in plain torch, of the port's plain ray cast and camera as
the benchmark found them: ``ops/raycast.py`` (``safe_div``, ``ray_box``,
``ray_sphere``, ``ray_cylinder``, ``ray_triangle``: lines 50-139),
``ops/raycast_cuda.py`` (``pack_pose`` 90-94, ``pack_prims_world`` 96-111,
``rotate_dirs`` 114-127, ``raycast_reference`` 305-389 in its depth and
segmentation modes) and ``sensors/raycast_sensor.py`` (``camera_ray_dirs``
30-50, ``sensor_world_pose`` 135-139, ``render`` 178-236 without noise,
``apply_range_limits``). The ray grid and the data-frame rotation are
worked out here from the camera block of the cell's configuration. The
rotation of each primitive into the world is written out elementwise, so a
block of envs rounds as the whole batch does. Imports nothing of the port.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import math3d as m

NO_HIT_RAY_VAL = 1000.0
NO_HIT_SEGMENTATION_VAL = -2
BIG = 1e10
TRI_EPS = 1e-6


def camera_ray_dirs(height: int, width: int, hfov_deg: float):
    """Unit ray directions (H, W, 3) of the optical frame (z forward) and
    the depth multiplier (H, W); numpy float32."""
    hfov = math.radians(hfov_deg)
    fx = (width / 2.0) / math.tan(hfov / 2.0)
    cx, cy = width / 2.0, height / 2.0
    u = (np.arange(width, dtype=np.float32)[None, :] - cx) / fx
    v = (np.arange(height, dtype=np.float32)[:, None] - cy) / fx
    dirs = np.stack([np.broadcast_to(u, (height, width)), np.broadcast_to(v, (height, width)),
                     np.ones((height, width), np.float32)], axis=-1)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    mult = dirs @ np.array([0.0, 0.0, 1.0], np.float32)
    return dirs.astype(np.float32), mult.astype(np.float32)


class Camera:
    """The camera block of a configuration, on a device."""

    def __init__(self, cfg: dict, device, dtype=torch.float32):
        dirs, mult = camera_ray_dirs(cfg["height"], cfg["width"], cfg["horizontal_fov_deg"])
        self.dirs = torch.as_tensor(dirs, device=device).to(dtype)
        self.mult = torch.as_tensor(mult, device=device).to(dtype)
        rot = torch.as_tensor(np.radians(cfg["euler_frame_rot_deg"]).astype(np.float32),
                              device=device)
        self.frame_quat = m.quat_from_euler_xyz(rot[0], rot[1], rot[2]).to(dtype)
        self.max_range = float(np.float32(cfg["max_range"]))
        self.min_range = float(np.float32(cfg["min_range"]))
        self.far, self.near = float(cfg["far_out_value"]), float(cfg["near_out_value"])
        self.normalize = bool(cfg["normalize_range"])
        self.height, self.width = cfg["height"], cfg["width"]


def safe_div(a, b):
    tiny = torch.where(b < 0, torch.full_like(b, -1e-12), torch.full_like(b, 1e-12))
    return a / torch.where(torch.abs(b) < 1e-12, tiny, b)


def ray_box(ro, rd, half):
    ix, iy, iz = (safe_div(1.0, rd[..., k]) for k in range(3))
    hx, hy, hz = half[..., 0], half[..., 1], half[..., 2]
    t1x, t2x = (-hx - ro[..., 0]) * ix, (hx - ro[..., 0]) * ix
    t1y, t2y = (-hy - ro[..., 1]) * iy, (hy - ro[..., 1]) * iy
    t1z, t2z = (-hz - ro[..., 2]) * iz, (hz - ro[..., 2]) * iz
    tmin = torch.maximum(torch.maximum(torch.minimum(t1x, t2x), torch.minimum(t1y, t2y)),
                         torch.minimum(t1z, t2z))
    tmax = torch.minimum(torch.minimum(torch.maximum(t1x, t2x), torch.maximum(t1y, t2y)),
                         torch.maximum(t1z, t2z))
    hit = tmax >= torch.clamp(tmin, min=0.0)
    t = torch.where(tmin > 0.0, tmin, tmax)
    return torch.where(hit & (t > 0.0), t, torch.full_like(t, BIG))


def ray_sphere(ro, rd, r):
    b = ro[..., 0] * rd[..., 0] + ro[..., 1] * rd[..., 1] + ro[..., 2] * rd[..., 2]
    c = (ro[..., 0] * ro[..., 0] + ro[..., 1] * ro[..., 1] + ro[..., 2] * ro[..., 2]) - r * r
    disc = b * b - c
    sq = m.safe_sqrt(disc)
    t0, t1 = -b - sq, -b + sq
    t = torch.where(t0 > 0.0, t0, t1)
    return torch.where((disc >= 0.0) & (t > 0.0), t, torch.full_like(t, BIG))


def ray_cylinder(ro, rd, r, h):
    rox, roy, roz = ro[..., 0], ro[..., 1], ro[..., 2]
    rdx, rdy, rdz = rd[..., 0], rd[..., 1], rd[..., 2]
    a = rdx * rdx + rdy * rdy
    b = rox * rdx + roy * rdy
    c = (rox * rox + roy * roy) - r * r
    disc = b * b - a * c
    sq = m.safe_sqrt(disc)
    inv_a = safe_div(1.0, a)
    ts0, ts1 = (-b - sq) * inv_a, (-b + sq) * inv_a
    half = 0.5 * h

    def side(t):
        z = roz + t * rdz
        ok = (disc >= 0.0) & (t > 0.0) & (torch.abs(z) <= half) & (a > 1e-12)
        return torch.where(ok, t, torch.full_like(t, BIG))

    def cap(zc):
        t = safe_div(zc - roz, rdz)
        x, y = rox + t * rdx, roy + t * rdy
        ok = (t > 0.0) & (x * x + y * y <= r * r) & (torch.abs(rdz) > 1e-12)
        return torch.where(ok, t, torch.full_like(t, BIG))

    return torch.minimum(torch.minimum(side(ts0), side(ts1)), torch.minimum(cap(half), cap(-half)))


def ray_triangle(ro, rd, size):
    a, b, c = size[..., 0], size[..., 1], size[..., 2]
    t = safe_div(-ro[..., 2], rd[..., 2])
    x = ro[..., 0] + t * rd[..., 0]
    y = ro[..., 1] + t * rd[..., 1]
    v = safe_div(y, c)
    u = safe_div(x - v * b, a)
    ok = ((t > 0.0) & (torch.abs(rd[..., 2]) > 1e-9) & (u >= -TRI_EPS) & (v >= -TRI_EPS)
          & (u + v <= 1.0 + TRI_EPS) & (a > 0.0))
    return torch.where(ok, t, torch.full_like(t, BIG))


def rotate_dirs(quat, dirs):
    """Sensor-frame dirs (R, 3) to world per env: (N, 4) -> (N, R, 3)."""
    qx, qy, qz, qw = (quat[:, k, None] for k in range(4))
    dx, dy, dz = dirs[None, :, 0], dirs[None, :, 1], dirs[None, :, 2]
    w2 = 2.0 * qw * qw - 1.0
    cx, cy, cz = qy * dz - qz * dy, qz * dx - qx * dz, qx * dy - qy * dx
    td = 2.0 * (qx * dx + qy * dy + qz * dz)
    tw = 2.0 * qw
    return torch.stack([dx * w2 + cx * tw + qx * td, dy * w2 + cy * tw + qy * td,
                        dz * w2 + cz * tw + qz * td], dim=-1)


def sensor_pose(cam: Camera, pos, quat, mount_pos, mount_quat):
    """World origin (N, 3) and quaternion (N, 4) of the camera."""
    origin = m.quat_rotate(quat, mount_pos) + pos
    return origin, m.quat_mul(quat, m.quat_mul(mount_quat, cam.frame_quat.expand_as(quat)))


def world_prims(scene: dict, obstacle_pos, obstacle_quat):
    """The local primitive tables composed with the obstacle poses ->
    (N, P, 16) [size(3) pos(3) R row-major(9) semantic]."""
    slot = scene["slot"]
    a_pos = torch.gather(obstacle_pos, 1, slot[..., None].expand(-1, -1, 3))
    a_quat = torch.gather(obstacle_quat, 1, slot[..., None].expand(-1, -1, 4))
    R_a = m.quat_to_rotation_matrix(a_quat)                            # (N, P, 3, 3)
    p_world = a_pos + m.rowwise_matmul(R_a, scene["pos"][..., None])[..., 0]
    R_w = m.rowwise_matmul(R_a, scene["rot"])
    N, P = slot.shape
    return torch.cat([scene["size"], p_world, R_w.reshape(N, P, 9),
                      scene["semantic"][..., None].to(p_world.dtype)], dim=-1)


def prim_counts(scene: dict):
    kinds = scene["kind"][0]
    return tuple(int((kinds == k).sum()) for k in range(4))


def cast(origin, quat, prims, dirs, mult, counts, max_range, want_seg=True):
    """Nearest hit of every (env, ray): depth (N, R) = t x mult
    (NO_HIT_RAY_VAL x mult on a miss) and the winner's semantic id (N, R)
    int32 (NO_HIT_SEGMENTATION_VAL on a miss)."""
    n_box, n_cyl, n_sph, _ = counts
    dirs, mult = dirs.reshape(-1, 3), mult.reshape(-1)
    dt = dirs.dtype
    dw = rotate_dirs(quat, dirs)
    dxw, dyw, dzw = dw[..., 0], dw[..., 1], dw[..., 2]
    t_best = torch.full(dxw.shape, BIG, dtype=dt, device=dirs.device)
    s_best = torch.full(dxw.shape, NO_HIT_SEGMENTATION_VAL, dtype=torch.int32, device=dirs.device)
    for p in range(prims.shape[1]):
        kind = 0 if p < n_box else 1 if p < n_box + n_cyl else 2 if p < n_box + n_cyl + n_sph else 3
        size = prims[:, p, 0:3][:, None, :]
        ux, uy, uz = (origin[:, k] - prims[:, p, 3 + k] for k in range(3))
        if kind == 2:
            t = ray_sphere(torch.stack([ux, uy, uz], dim=-1)[:, None, :], dw, size[..., 0])
        else:
            r = [prims[:, p, 6 + k, None] for k in range(9)]
            ro = torch.stack([r[0][:, 0] * ux + r[3][:, 0] * uy + r[6][:, 0] * uz,
                              r[1][:, 0] * ux + r[4][:, 0] * uy + r[7][:, 0] * uz,
                              r[2][:, 0] * ux + r[5][:, 0] * uy + r[8][:, 0] * uz],
                             dim=-1)[:, None, :]
            rd = torch.stack([r[0] * dxw + r[3] * dyw + r[6] * dzw,
                              r[1] * dxw + r[4] * dyw + r[7] * dzw,
                              r[2] * dxw + r[5] * dyw + r[8] * dzw], dim=-1)
            if kind == 0:
                t = ray_box(ro, rd, 0.5 * size)
            elif kind == 1:
                t = ray_cylinder(ro, rd, size[..., 0], size[..., 1])
            else:
                t = ray_triangle(ro, rd, size)
        closer = t < t_best
        t_best = torch.where(closer, t, t_best)
        if want_seg:
            s_best = torch.where(closer, prims[:, p, 15, None].to(torch.int32), s_best)
    miss = t_best >= min(max_range, 0.5 * BIG)
    t_best = torch.where(miss, torch.full_like(t_best, NO_HIT_RAY_VAL), t_best)
    seg = torch.where(miss, torch.full_like(s_best, NO_HIT_SEGMENTATION_VAL), s_best)
    return t_best * mult[None, :], (seg if want_seg else None)


def render(cam: Camera, scene: dict, state: dict, want_seg=True, chunk: int = 64):
    """Depth image (N, H, W) as the sensor returns it (range limits, then
    normalised by the range) and the segmentation (N, H, W) int32 or None,
    from the state's robot pose, camera mount and obstacle poses. ``chunk``
    envs are cast at a time."""
    dt = cam.dirs.dtype
    f = lambda k: state[k].to(dt)
    origin, quat = sensor_pose(cam, f("pos"), f("quat"), f("cam_mount_pos"), f("cam_mount_quat"))
    scene = {k: (v.to(dt) if v.is_floating_point() else v) for k, v in scene.items()}
    prims = world_prims(scene, f("obstacle_pos"), f("obstacle_quat"))
    counts = prim_counts(scene)
    depths, segs = [], []
    for lo in range(0, origin.shape[0], chunk):
        d, s = cast(origin[lo:lo + chunk], quat[lo:lo + chunk], prims[lo:lo + chunk],
                    cam.dirs, cam.mult, counts, cam.max_range, want_seg)
        depths.append(d)
        segs.append(s)
    N = origin.shape[0]
    pixels = torch.cat(depths).reshape(N, cam.height, cam.width)
    pixels = torch.where(pixels > cam.max_range, torch.full_like(pixels, cam.far), pixels)
    pixels = torch.where(pixels < cam.min_range, torch.full_like(pixels, cam.near), pixels)
    if cam.normalize:
        pixels = pixels / cam.max_range
    seg = torch.cat(segs).reshape(N, cam.height, cam.width) if want_seg else None
    return pixels, seg
