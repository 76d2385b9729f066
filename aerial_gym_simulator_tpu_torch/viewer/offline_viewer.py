"""Offline viewer: a headless render-to-image stand-in for the reference's
interactive Isaac Gym viewer (``IGE_viewer_control.py:16-296``).

Counterpart of ``aerial_gym_simulator_tpu/viewer/offline_viewer.py``.
Attach an OfflineViewer to a running sim, call ``render(state)`` every step
(or every Nth) and get chase-camera colour frames (numpy uint8), coloured
from the ray-cast depth and segmentation. Frames can be written as PPM files
or as an uncompressed .avi (raw RGB) that plays anywhere, with no imaging
dependency.

Camera modes, after the reference's follow modes:
  * "follow_robot": a chase camera behind env i's robot (FOLLOW_ROBOT);
  * "fixed": a static camera at a configured pose (FIXED).

The frame is cast on the params' device through ``ops/raycast_cuda.raycast``
with segmentation, so the card runs K2 (``raycast_kernel<kSeg>``) on one env:
the pose is the camera's position with the identity quaternion, the rays an
(H, W, 3) grid of world-frame directions (the optical-frame grid of
``camera_ray_dirs`` turned by the look-at basis), the depth multiplier
ones, and the primitive table env i's rows alone. The robot marker and the
colouring are plain torch on the device; only the uint8 frame is copied to
the host. The empty env launches nothing.
"""

from __future__ import annotations

import logging
import os
import struct
from typing import Optional

import numpy as np
import torch

from ..ops import raycast, raycast_cuda
from ..sensors.raycast_sensor import camera_ray_dirs
from ..sim.structs import replace

logger = logging.getLogger("offline_viewer")

# distinct colours for segmentation ids (cycled)
PALETTE = np.array([
    [230, 80, 60], [60, 160, 230], [90, 200, 90], [240, 190, 60],
    [170, 110, 220], [240, 130, 180], [120, 210, 200], [250, 150, 70],
], np.uint8)
SKY = (20, 24, 38)
ROBOT_SEG = -10           # the robot marker's id in the segmentation


class OfflineViewer:
    def __init__(self, params, width: int = 320, height: int = 240, hfov_deg: float = 90.0,
                 env_id: int = 0, mode: str = "follow_robot", camera_position=(-2.5, 0.0, 1.5),
                 lookat_offset=(0.0, 0.0, 0.0), max_range: float = 30.0):
        self.params = params
        self.device = params.device
        self.width, self.height = width, height
        self.env_id = env_id
        self.mode = mode
        self.camera_position = np.asarray(camera_position, np.float32)
        self.lookat_offset = np.asarray(lookat_offset, np.float32)
        self.max_range = max_range
        dirs, _ = camera_ray_dirs(height, width, hfov_deg)
        self._dirs = torch.as_tensor(dirs.reshape(-1, 3), device=self.device)   # optical
        self._ones = torch.ones((height, width), dtype=torch.float32, device=self.device)
        self._palette = torch.as_tensor(PALETTE, device=self.device)
        self.frames = []

    # -- core ---------------------------------------------------------------
    def _camera_pose(self, state):
        """(camera position, look-at target), world frame, (3,) each."""
        p = state.pos[self.env_id]
        f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=p.device)
        target = p + f32(self.lookat_offset)
        cam = f32(self.camera_position)
        if self.mode == "follow_robot":
            cam = p + cam
        return cam, target

    def _world_dirs(self, cam, target) -> torch.Tensor:
        """The (H*W, 3) optical-frame rays turned into the look-at basis:
        columns right, -up, forward (the optical frame's x right and y down
        in the image, z forward)."""
        fwd = target - cam
        fwd = fwd / torch.clamp(torch.linalg.norm(fwd), min=1e-6)
        up0 = torch.tensor([0.0, 0.0, 1.0], device=cam.device)
        right = torch.linalg.cross(fwd, up0)
        right = right / torch.clamp(torch.linalg.norm(right), min=1e-6)
        up = torch.linalg.cross(right, fwd)
        R = torch.stack([right, -up, fwd], dim=1)
        return self._dirs @ R.T

    def cast_inputs(self, state):
        """The ray cast's arguments for this frame: (pose (1, 8), prims
        (1, P, 16) of env i, dirs (H, W, 3), mult (H, W), n_box, n_cyl,
        n_sph, max_range, n_tri), or None for an empty env."""
        sc = self.params.scene
        if sc is None or sc.num_env_prims == 0:
            return None
        cam, target = self._camera_pose(state)
        dirs = self._world_dirs(cam, target).reshape(self.height, self.width, 3).contiguous()
        rows = slice(self.env_id, self.env_id + 1)
        one = replace(sc, **{k: getattr(sc, k)[rows] for k in (
            "env_prim_slot", "env_prim_size", "env_prim_pos", "env_prim_rot",
            "env_prim_semantic")})
        prims = raycast_cuda.pack_prims_world(one, state.obstacle_pos[rows],
                                              state.obstacle_quat[rows])
        identity = torch.tensor([[0.0, 0.0, 0.0, 1.0]], device=cam.device)
        pose = raycast_cuda.pack_pose(cam[None], identity)
        return (pose, prims, dirs, self._ones, sc.n_box, sc.n_cyl, sc.n_sph, self.max_range,
                sc.n_tri)

    def scene_hits(self, state):
        """The scene's (depth (R,), seg (R,)) for this frame: K2 on a CUDA
        state (its plain version on the CPU); misses everywhere in an empty
        env, with no launch."""
        args = self.cast_inputs(state)
        if args is None:
            R = self.height * self.width
            return (torch.full((R,), raycast.NO_HIT_RAY_VAL, device=self.device),
                    torch.full((R,), raycast.NO_HIT_SEGMENTATION_VAL, dtype=torch.int32,
                               device=self.device))
        *cast, n_tri = args
        depth, seg = raycast_cuda.raycast(*cast, want_seg=True, n_tri=n_tri)
        return depth[0], seg[0]

    def _render(self, state):
        """-> (depth (H, W), seg (H, W)) with the robot marker: the robot's
        collision sphere, id ROBOT_SEG, where it is nearer than the scene."""
        t, sem = self.scene_hits(state)
        cam, target = self._camera_pose(state)
        rd = self._world_dirs(cam, target)
        ro = (cam - state.pos[self.env_id]).expand_as(rd)
        t_robot = raycast.ray_sphere(ro, rd, self.params.robot.collision_radius)
        closer = t_robot < t
        t = torch.where(closer, t_robot, t)
        sem = torch.where(closer, torch.full_like(sem, ROBOT_SEG), sem)
        return t.reshape(self.height, self.width), sem.reshape(self.height, self.width)

    def colorize(self, t: torch.Tensor, sem: torch.Tensor) -> torch.Tensor:
        """(H, W) depth and seg -> (H, W, 3) uint8 on the device: the
        segment's colour faded by depth, the sky on a miss, the robot white."""
        shade = torch.clamp(1.0 - t / self.max_range, 0.0, 1.0)
        hit = t < raycast.NO_HIT_RAY_VAL * 0.9
        colors = self._palette[(sem.abs() % len(PALETTE)).long()]
        img = (colors.to(torch.float32) * shade[..., None]).to(torch.uint8)
        img = torch.where(hit[..., None], img,
                          torch.tensor(SKY, dtype=torch.uint8, device=img.device))
        white = (255.0 * shade.to(torch.float64)[..., None]).to(torch.uint8).expand_as(img)
        return torch.where((sem == ROBOT_SEG)[..., None], white, img)

    def render(self, state, store: bool = True) -> np.ndarray:
        """Render one RGB frame (H, W, 3) uint8 on the host."""
        img = self.colorize(*self._render(state)).cpu().numpy()
        if store:
            self.frames.append(img)
        return img

    # -- output -------------------------------------------------------------
    def save_ppm_sequence(self, out_dir: str):
        os.makedirs(out_dir, exist_ok=True)
        for i, img in enumerate(self.frames):
            with open(os.path.join(out_dir, f"frame_{i:05d}.ppm"), "wb") as f:
                f.write(f"P6\n{self.width} {self.height}\n255\n".encode())
                f.write(img.tobytes())
        logger.info("wrote %d frames to %s", len(self.frames), out_dir)

    def save_avi(self, path: str, fps: int = 30):
        """A minimal uncompressed AVI writer (RGB24, no dependency)."""
        frames = self.frames
        if not frames:
            raise ValueError("no frames recorded")
        h, w = self.height, self.width
        frame_size = w * h * 3
        n = len(frames)

        def chunk(tag, payload):
            pad = b"\x00" if len(payload) % 2 else b""
            return tag + struct.pack("<I", len(payload)) + payload + pad

        # RGB24 AVI frames are BGR rows, bottom up
        raw = [img[::-1, :, ::-1].tobytes() for img in frames]
        # AVIMAINHEADER (no index chunk is written, so no AVIF_HASINDEX)
        avih = struct.pack("<14I", int(1e6 / fps), frame_size * fps, 0, 0,
                           n, 0, 1, frame_size, w, h, 0, 0, 0, 0)
        # AVISTREAMHEADER: fccType fccHandler flags prio+lang initialframes
        # scale rate start length suggestedbuf quality samplesize rcFrame(4H)
        strh = (b"vids" + b"DIB "
                + struct.pack("<IIIIIIIIIi4H", 0, 0, 0, 1, fps, 0, n,
                              frame_size, 0xFFFFFFFF & -1, 0, 0, 0, w, h))
        strf = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, frame_size, 0, 0, 0, 0)
        strl = chunk(b"LIST", b"strl" + chunk(b"strh", strh) + chunk(b"strf", strf))
        hdrl = chunk(b"LIST", b"hdrl" + chunk(b"avih", avih) + strl)
        movi = chunk(b"LIST", b"movi" + b"".join(chunk(b"00db", r) for r in raw))
        riff = b"AVI " + hdrl + movi
        with open(path, "wb") as f:
            f.write(b"RIFF" + struct.pack("<I", len(riff)) + riff)
        logger.info("wrote a %d-frame AVI to %s", n, path)

    def reset(self):
        self.frames = []
