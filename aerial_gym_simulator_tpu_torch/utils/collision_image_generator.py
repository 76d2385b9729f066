"""Inflated-obstacle depth for collision-label datasets.

Counterpart of ``aerial_gym_simulator_tpu/utils/collision_image_generator.py``.
Every primitive is grown by the robot's collision radius (the analytic
sphere sweep of the primitive soup) and the inflated scene is rendered
with the standard caster: on the card one launch of the ray-cast kernel's
segmentation mode (``ops/raycast_cuda.raycast``, K2) on a table packed from
the inflated scene, on the CPU its plain version. The depth of that render
is the per-pixel distance at which the robot would touch an obstacle.
"""

from __future__ import annotations

import torch

from ..ops import raycast_cuda
from ..sensors.raycast_sensor import cast_inputs
from ..sim.structs import SimParams, SimState, replace


def inflate_scene(scene, radius: float):
    """Grow every primitive by ``radius``: a box by 2r on every extent, a
    cylinder by r on its radius and 2r on its height, any other kind by r
    on ``size[..., 0]`` (a sphere's radius; a triangle's first edge gets
    the same, as in the JAX package)."""
    size = scene.env_prim_size
    kind = scene.env_prim_kind[..., None]
    grow_box = size + 2.0 * radius
    grow_cyl = size.clone()
    grow_cyl[..., 0] += radius
    grow_cyl[..., 1] += 2.0 * radius
    grow_sph = size.clone()
    grow_sph[..., 0] += radius
    new_size = torch.where(kind == 0, grow_box, torch.where(kind == 1, grow_cyl, grow_sph))
    return replace(scene, env_prim_size=new_size)


def inflated_cast_inputs(params: SimParams, state: SimState, inflation_radius: float = None,
                         use_camera: bool = True):
    """The ray-cast kernel's inputs for the inflated scene from the camera
    (or the lidar), packed as ``raycast_sensor.cast_inputs`` packs every
    capture, with the robot's collision radius as the default radius ->
    (the inputs of ``raycast_cuda.raycast``, the scene's n_tri)."""
    sp = params.camera if use_camera else params.lidar
    if sp is None:
        raise ValueError("no sensor configured on this robot")
    if params.scene is None or params.scene.num_env_prims == 0:
        raise ValueError("render_inflated_depth needs an obstacle scene")
    if inflation_radius is None:
        inflation_radius = float(params.robot.collision_radius)
    inflated = replace(params, scene=inflate_scene(params.scene, inflation_radius))
    mount_pos = state.cam_mount_pos if use_camera else state.lidar_mount_pos
    mount_quat = state.cam_mount_quat if use_camera else state.lidar_mount_quat
    return cast_inputs(inflated, state, sp, mount_pos, mount_quat), inflated.scene.n_tri


def render_inflated_depth(params: SimParams, state: SimState, inflation_radius: float = None,
                          use_camera: bool = True):
    """Depth and segmentation of the inflated scene from the camera (or the
    lidar) -> (depth (N, H, W) f32, seg (N, H, W) int32): the hit distance
    times the sensor's depth multiplier, with no noise and no range limits.
    The radius defaults to the robot's collision radius."""
    inputs, n_tri = inflated_cast_inputs(params, state, inflation_radius, use_camera)
    depth, seg = raycast_cuda.raycast(*inputs, want_seg=True, n_tri=n_tri)
    sp = params.camera if use_camera else params.lidar
    N = state.pos.shape[0]
    return depth.reshape(N, sp.height, sp.width), seg.reshape(N, sp.height, sp.width)
