#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py [--parent-attention FILE]

``--parent-attention`` builds another ``attention.cu`` (the parent commit's,
unpacked outside the package) beside the shipped one, times its bf16
serving kernel in turns with the shipped one on the same tensors, and holds
the shipped narrow, staged, ring and wide kernels bit for bit to the
parent's on the same tensors.

Phases, each printed on its own line:
  1. build   - compile the ray-cast kernel in its four modes (csrc/raycast.cu)
               and the fused attention kernels, forward and backward
               (csrc/attention.cu), with nvcc, side by side, and two A/B
               builds of the ray cast (-fmad=true; -prec-div=false); ptxas's
               registers, spills and static shared memory of every kernel by
               its symbol;
  2. device  - the card's name and power limit (nvidia-smi);
  3. kernel  - the ray cast in depth (K1) and depth+seg (K2) mode against
               its plain PyTorch version on the card, on the obstacle env at
               64 envs with the full 135x240 camera grid (after reset and
               after 20 steps) and on a seeded synthetic scene with all four
               primitive kinds: every output bit-equal, broad phase on ==
               off. The normal/face-id (K3) and RGB (K4) modes on the same
               three inputs: every output bit-equal, exact sentinels on a
               miss, rgb in [0, 1], broad phase on == off; then all four on
               the 128x512 lidar grid at 64 envs.
               The attention forward (K5) against its plain version on
               numpy-seeded q, k, v: f32 at the ViT training shape (64, 225,
               256) at 8 and 4 heads, head sizes 136 and 256 (the one-pass
               wide kernels), 257, 512, 768 and 2,048 (the cluster kernels)
               and 2,049 (the sliced kernels) among others, within atol/rtol
               1e-4, bf16 within 0.05 (S = 900 and 1,600, and head sizes 512
               and 1,024 among them); a non-contiguous input must raise.
               The attention backward (K6) against its plain version at the
               ViT training shape f32, at head_dim 64 f32 (ragged, S = 225,
               and S = 300), head_dim 136 and 256 (also at the one-head
               training shape (64, 225, 256, 1)), 257, 512, 768, 2,048 and
               2,049 within 2e-4, at (1024, 225, 256) bf16 and at head_dim
               64, 256, 512 and 1,024 bf16 within 0.02, and a second call on
               the same inputs bit for bit;
  4. slice   - the obstacle env + depth camera at 16384 envs through the
               user entry points: env_step + render_camera(want_seg=False)
               with zero actions (the bench loop), then EnvManager.step +
               render() (segmentation camera); finite outputs, the kernels'
               launch counts from that run, throughput and peak memory;
     modalities - the obstacle env at 16384 envs with the normal/face-id
               camera: env.step + render_normal_faceid_camera (K3), then
               env.step + render("rgb") (K2 + K4); finite outputs, rgb_pixels
               (N, 135, 240, 3), launch counts, env-steps/s, peak memory;
     lidar   - the obstacle env at 1024 envs with the 128x512 lidar:
               env.step + render() (K2) + render_normal_faceid_lidar (K3);
               finite outputs, launch counts, env-steps/s, peak memory;
  5. nav     - the navigation task at 1024 envs (lmf2, 135x240 camera)
               flown closed loop for 150 steps by the shipped ViT encoder
               (dim 256, depth 4, 8 heads, bf16, attention through K5) and
               policy: finite outputs, K1 launched once and K5 four times
               per step, success share above 0.3, throughput, the step's
               split and peak memory; the run's depth images encoded by the
               flown encoder and by its pickle re-tagged "reference" (plain
               attention), latents within atol 0.05 + rtol 0.05; then 20
               steps with the shipped conv VAE and its policy (no K5
               launch);
  6. timing  - each kernel at its main path's shapes against its plain
               version (the ray cast bit for bit, broad phase on == off, on
               every path: obstacle loop, nav, modalities, lidar, train_vae's
               sampling), its least possible time on this card and, for K5
               and K6, torch's scaled_dot_product_attention (forward,
               backward) on the same tensors, kernel and library each the
               median of alternating windows after an untimed call, with
               their spread: K5 at the serving shape in bf16 (8 and 4 heads,
               with the exp floor, B H S^2 exp2 over the special-function
               units, beside the bound; and the parent's serving kernel
               with --parent-attention), at S = 900 and 1,600 in bf16, and
               at the training shape in f32 (8 and 4 heads: head_dim 32,
               64), K6 the same way (8 and 4 heads f32, and bf16 at the
               serving shape), timed as autograd runs it (from the forward's
               output and L) and as a whole direct call; the one-pass wide
               kernels at the one-head training shape (64, 225, 256, 1) f32,
               forward and backward (each backward kernel's device time by
               torch.profiler), and the wide forward in bf16 at (1024, 225,
               256, 1), each forward beside the sliced kernel it replaced on
               the same tensors; the cluster kernels at head_dim 512 (64,
               225, 512, 1) f32, forward and backward, each beside the sliced
               kernels on the same tensors (each cluster backward kernel's
               device time by torch.profiler), the cluster forward in bf16 at
               (1024, 225, 512, 1) beside the sliced one, and the clusters
               the card holds of each cluster kernel at head 512. Each
               attention timing holds its output against the plain version
               at its tolerance. The
               "flash" path (f32 kernel on f32 copies) at the serving shape
               and the shipped encoder re-tagged "flash"; K3 and K4 at the
               modalities path's shape and K2, K3 at the lidar path's. The
               ray cast's bound counts the tests that a broad phase on the
               primitives' bounding spheres could not skip, the same for any
               tiling; each line also prints the tests per ray the kernel's
               warp patches keep and those 256-ray strips kept. K1 also from
               the two A/B builds on the obstacle path's inputs, each image
               against the shipped build's;
  7. train   - models/train_vae at full width (ViT dim 256, depth 4, 8
               heads, fused attention, batch 64, 135x240, f32) for 60 steps:
               finite falling loss, K1 once and K5 and K6 four times per
               step, the checkpoint read back through load_encoder_pickle,
               the step's split and peak memory; then 5 steps of the conv
               VAE;
     train1  - train_vae at the same width with one head (head_dim 256) for
               20 steps: finite falling loss, K1 once and the one-pass wide
               forward and backward four times per step each (counted apart
               from the narrow kernels), the step's split and peak memory;
     train512 - train_vae at the large ViT's width with one head (dim 512,
               depth 12, head_dim 512) for 60 steps: finite falling loss, K1
               once and the cluster forward and backward 12 times per step
               each, no sliced launch; the same 60 steps with the plain
               attention (--vit_attn xla, no attention kernel): every step's
               loss within 1e-4 of the kernels' run; the step's split and
               peak memory;
  8. ppo     - position PPO at PPOConfig's defaults (8192 envs x 32 steps,
               minibatch 8192, 4 epochs) for 3 iterations: finite metrics,
               parameters moved, lr inside its bounds, env-steps/s and the
               rollout / update split; the state-step rate of the position
               task at 16384 envs with zero actions through make_step_fn;
               and the shipped position policy flown for 250 steps (no
               crash, mean distance under 0.5 m over the last 100).
  9. navppo  - navigation PPO: the rl.ppo command line's trainer
               (build_trainer) on navigation_task at 1024 envs with the
               shipped ViT encoder (dim 256, 8 heads, bf16) through
               make_step_fn / set_carry, 4 iterations of 32 steps: finite
               losses, parameters moved, K1 once and K5 four times per env
               step, s/iteration, env-steps/s, reward, the rollout / update
               split, and the encoder against its plain version on the final
               depth images; the trained state is the straight run that
               phase 12 resumes to;
     lidarnav - lidar_navigation_task (magpie, magpie_acceleration_control,
               env_with_lidar_nav_obstacles) at 512 envs flown 330 steps
               (three episodes) by the shipped lidar_navigation_policy.npz:
               finite actions, at least one success, K1 once per step on the
               48x120 dome table, success share, env-steps/s and the step's
               split (env_step, render, pointcloud processing, policy); K1
               on this scene and table bit-equal to its plain version, timed,
               with its bound;
     radarnav - radar_navigation_task (lmf2_radar, lmf2_acceleration_control)
               at 512 envs flown 450 steps by the shipped GRU policy with
               per-env hidden resets (at least one success, the JAX
               package's bar), K1 as for lidarnav on the radar cone; then 2
               iterations of recurrent PPO (rnn "gru", 128 units, 32 steps):
               finite losses, the policy moved, s/iteration.
 10. collision - models/train_vae --collision_targets at the JAX CLI's
               defaults (conv VAE, batch 64, 135x240, Adam 1e-4) for 30
               steps: finite losses, K1 (the raw render) and K2 (the render
               of the scene inflated by the robot's collision radius) once
               per step each, ms/step and its split (sample + render,
               inflated render, forward, backward, Adam); K2 on the inflated
               table bit-equal to its plain version, timed, with its bound;
 11. variants - the four position-task variants (sim2real and acceleration
               on lmf2, end-to-end on tinyprop and px4 on x500, the last two
               under no_control) at their configs' envs (16, 16, 4096, 24),
               100 steps each from seeded actions: finite observations and
               rewards of the right shapes, env-steps/s, reward mean,
               crashes and truncations; 3 iterations of PPO on the
               end-to-end task at 4096 envs x 32; base_octarotor and
               base_random (lee_position_control) and base_rov
               (rov_fully_actuated_control) at 1024 envs for 100 steps,
               finite poses; the device's idle share of a variant step and
               of a robot step; no kernel launch on any of these paths.
 12. plumbing - the training plumbing: a. `python -m
               aerial_gym_simulator_tpu_torch.rl.ppo` as a subprocess
               (position task, 8192 envs x 32, 3 iterations, --logdir,
               --save): rc 0, the final line, metrics.jsonl with the JAX
               package's keys, the saved policy exported and flown on the
               card; b. exact resume: navigation PPO at 1024 envs (the
               command line's trainer, the shipped ViT) for 2 iterations
               saved to a training-state directory and thrown away, a fresh
               trainer resumed to 4: parameters, Adam state, normalizer, lr,
               observation, generator states and env_carry.pos bit-equal to
               navppo's straight run, K1 once and K5 four times per env
               step, the checkpoint's MB and save / restore ms; c. saved sim
               state: the obstacle env at 1024 envs with a noisy
               segmentation camera, save_state after 5 steps, 3 steps with
               render() (K2), load_state, the 3 again: poses and frames
               bit-equal; d. AerialGymVecEnv over navigation_task (1024
               envs, conv VAE) with CUDA torch actions (numpy out, bool
               dones, K1 10), CustomTask at 16384 envs for 20 steps, and
               navigation_task with a seeded reference-layout .pth VAE
               (models/torch_vae_import) for 20 steps (K1 20), its latents on
               the card within 1e-4 of the same module on the CPU; each
               part's seconds.

Before the last line it prints one JSON object with a record per kernel;
the last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without that line. Without CUDA it exits 1 at once.
"""

import dataclasses
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

NUM_ENVS = 16384
MODALITY_STEPS = 3
LIDAR_ENVS = 1024
LIDAR_STEPS = 3
RAYCAST_SOURCE = "aerial_gym_simulator_tpu_torch/csrc/raycast.cu"
RAYCAST_REPLACES = "aerial_gym_simulator_tpu/ops/raycast_pallas.py:90"
ATTENTION_SOURCE = "aerial_gym_simulator_tpu_torch/csrc/attention.cu"
ATTENTION_REPLACES = "aerial_gym_simulator_tpu/ops/attention_pallas.py:153"
ATTENTION_BWD_REPLACES = "aerial_gym_simulator_tpu/ops/attention_pallas.py:169"

NAV_ENVS = 1024
# one and a half 100-step episodes: the outcomes of every env's first one
NAV_STEPS = 150
NAV_CONV_STEPS = 20
NAV_SUCCESS_SHARE = 0.3
NETWORKS = Path(__file__).resolve().parent / "examples/dce_rl_navigation/selected_network"
# (B, S, D, heads), dtype name, atol = rtol
ATTENTION_CASES = [
    ((2, 17, 128, 4), "float32", 1e-4),
    ((1, 225, 128, 4), "float32", 1e-4),
    ((3, 128, 256, 8), "float32", 1e-4),
    ((2, 300, 256, 8), "float32", 1e-4),
    ((64, 225, 256, 8), "float32", 1e-4),       # the training path's shape and type
    ((2, 225, 256, 4), "float32", 1e-4),        # head_dim 64
    ((64, 225, 256, 8), "bfloat16", 0.05),
    ((2, 100, 256, 4), "bfloat16", 0.05),       # head_dim 64
    ((2, 225, 256, 1), "float32", 1e-4),        # head_dim 256: the one-pass wide kernel
    ((2, 65, 272, 2), "float32", 1e-4),         # head_dim 136, a short last key tile
    ((2, 225, 512, 2), "bfloat16", 0.05),       # head_dim 256 in bf16
    # the cluster kernels: head_dim 512 (a cluster of 2), 257 (its second rank
    # holds one column), 768, 1,024 and 2,048 (8 blocks, the largest)
    ((1, 225, 512, 1), "float32", 1e-4),
    ((1, 225, 1024, 2), "bfloat16", 0.05),
    ((1, 65, 514, 2), "float32", 1e-4),
    ((1, 100, 768, 1), "float32", 1e-4),
    ((1, 65, 1024, 1), "bfloat16", 0.05),
    ((1, 33, 2048, 1), "float32", 1e-4),
    ((1, 33, 2049, 1), "float32", 1e-4),        # past the clusters' reach: the sliced kernel
    # past the staged serving kernel's shared-memory limit: the ring kernel
    ((2, 900, 256, 4), "bfloat16", 0.05),       # the ViT at 270x480 with 4 heads
    ((1, 1600, 256, 8), "bfloat16", 0.05),
]
ATTENTION_MAIN_SHAPE = (NAV_ENVS, 225, 256, 8)   # the shipped ViT encoder's
SERVING_HD64_SHAPE = (NAV_ENVS, 225, 256, 4)     # the same width at 4 heads
LONG_SHAPES = [(2, 900, 256, 4), (1, 1600, 256, 8)]   # bf16: the ring kernel; refused before it
TIMING_WINDOWS = 5        # alternating windows of each timed attention call

# the training phases
TRAIN_BATCH = 64
TRAIN_STEPS = 60
TRAIN_CONV_STEPS = 5
TRAIN_ARGS = ["--arch", "vit", "--vit_attn", "fused", "--vit_dim", "256", "--vit_depth", "4",
              "--vit_heads", "8", "--batch", str(TRAIN_BATCH), "--image_h", "135",
              "--image_w", "240", "--log_every", "1"]
ATTENTION_TRAIN_SHAPE = (TRAIN_BATCH, 225, 256, 8)      # f32: K6's main path
WIDE_HEAD_SHAPE = (TRAIN_BATCH, 225, 256, 1)            # head_dim 256: the one-pass wide kernels
WIDE_SERVING_SHAPE = (NAV_ENVS, 225, 256, 1)            # the wide forward in bf16 at the serving batch
CLUSTER_SHAPE = (TRAIN_BATCH, 225, 512, 1)              # head_dim 512: the cluster kernels
CLUSTER_SERVING_SHAPE = (NAV_ENVS, 225, 512, 1)         # the cluster forward in bf16
# train_vae at the shipped width with one head: head_dim 256, the wide kernels
TRAIN_WIDE_STEPS = 20
TRAIN_WIDE_ARGS = TRAIN_ARGS + ["--vit_heads", "1"]      # argparse keeps the last
# train_vae at the large ViT's width (dim 512, depth 12: scripts/vit_remat_bench.py)
# with one head: head_dim 512, the cluster kernels. 60 steps, as the shipped
# width's phase: at this depth the loss stays on a plateau for about the
# first 30 steps, with the plain attention as with the kernels
TRAIN512_STEPS = 60
TRAIN512_ARGS = TRAIN_ARGS + ["--vit_dim", "512", "--vit_depth", "12", "--vit_heads", "1"]
# the same run with the plain attention under autograd ("xla"): each step's
# loss within this of the kernels' run (the f32 attention forward's own bar)
TRAIN512_PLAIN_TOL = 1e-4
# (B, S, D, heads), dtype name, atol = rtol
ATTENTION_BWD_CASES = [
    (ATTENTION_TRAIN_SHAPE, "float32", 2e-4),
    (ATTENTION_MAIN_SHAPE, "bfloat16", 0.02),   # five times the error seen there
    ((2, 100, 256, 4), "float32", 2e-4),        # ragged, head_dim 64
    ((2, 225, 256, 4), "float32", 2e-4),        # head_dim 64 at the ViT sequence
    ((1, 300, 256, 4), "float32", 2e-4),        # past the old shared-memory limit
    ((2, 225, 256, 4), "bfloat16", 0.02),       # head_dim 64
    ((2, 225, 256, 1), "float32", 2e-4),        # head_dim 256: the one-pass wide kernels
    (WIDE_HEAD_SHAPE, "float32", 2e-4),         # their one-head training path: 1.94 waves
    ((2, 65, 272, 2), "float32", 2e-4),         # head_dim 136, a short last tile
    ((2, 225, 512, 2), "bfloat16", 0.02),       # head_dim 256 in bf16
    # the cluster kernels, as in the forward's cases
    ((1, 225, 512, 1), "float32", 2e-4),
    ((1, 225, 1024, 2), "bfloat16", 0.02),
    ((1, 65, 514, 2), "float32", 2e-4),
    ((1, 100, 768, 1), "float32", 2e-4),
    ((1, 65, 1024, 1), "bfloat16", 0.02),
    ((1, 33, 2048, 1), "float32", 2e-4),
    ((1, 33, 2049, 1), "float32", 2e-4),        # past the clusters' reach: the sliced kernels
]
PPO_ITERATIONS = 3
NAVPPO_ITERATIONS = 4              # navigation PPO at NAV_ENVS x PPOConfig's horizon (32)
NAVPPO_ARGS = ["--task", "navigation_task", "--num_envs", str(NAV_ENVS), "--horizon", "32",
               "--seed", "7", "--vae_params", str(NETWORKS / "vit_depth_encoder.pkl")]
RESUME_AT = 2                      # plumbing: the victim run's iterations
CLI_ARGS = ["--task", "position_setpoint_task", "--num_envs", "8192", "--horizon", "32",
            "--total_steps", str(3 * 8192 * 32)]      # 3 iterations at ppo_aerial_quad.yaml's width
SIM_STATE_ENVS = 1024
CUSTOM_ENVS = 16384
VAE_CPU_IMAGES = 16                # images encoded on the card and on the CPU
LIDARNAV_ENVS = 512                # the lidar and radar recipes' envs
LIDARNAV_STEPS = 330               # three 110-step episodes
RADARNAV_STEPS = 450               # the JAX package's bar for the shipped radar policy
RADAR_PPO_ITERATIONS = 2
RADAR_RNN_HIDDEN = 128             # the radar recipe's GRU
LIDAR_NAV_POLICY = NETWORKS / "lidar_navigation_policy.npz"
RADAR_NAV_POLICY = NETWORKS / "radar_navigation_policy.npz"
COLLISION_STEPS = 30               # train_vae --collision_targets at the JAX CLI's defaults
COLLISION_ARGS = ["--arch", "conv", "--collision_targets", "--log_every", "1"]
VARIANT_STEPS = 100
VARIANT_TASKS = {                  # name -> the observation width; each at its config's envs
    "position_setpoint_task_sim2real": 17,
    "position_setpoint_task_acceleration_sim2real": 17,
    "position_setpoint_task_sim2real_end_to_end": 15,
    "position_setpoint_task_sim2real_px4": 15,
}
VARIANT_PPO_TASK = "position_setpoint_task_sim2real_end_to_end"
VARIANT_PPO_ENVS = 4096
VARIANT_PPO_ITERATIONS = 3
ROBOT_ENVS = 1024
ROBOT_STEPS = 100
ROBOT_PAIRS = (("base_octarotor", "lee_position_control"),
               ("base_random", "lee_position_control"),
               ("base_rov", "rov_fully_actuated_control"))
STATE_STEP_ENVS = 16384
STATE_STEPS = 100
POSITION_POLICY = (Path(__file__).resolve().parent
                   / "aerial_gym_simulator_tpu/sim2real/weights/position_policy.npz")

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12     # an f32-accurate product takes three (3xTF32)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32 operations of the ray cast, counted from csrc/raycast.cu: multiplies,
# adds and subtracts (a negation folded into them), divides, square roots,
# min/max; fabs, compares and selects not counted. Each value is counted
# once, where it is fixed: by the (env, primitive) pair, the (env, ray)
# pair, the (ray, primitive) test or the hit ray; bit-equality with the
# plain version fixes the expressions.
# per (ray, primitive) test (test_box, test_cylinder, test_sphere,
# test_triangle), the rotation of the ray into the primitive's frame included
FLOPS_PER_TEST = {0: 35, 1: 54, 2: 11, 3: 25}
# per (env, primitive), once, for the pairs some ray has to test
# (stage_record): o - p; R^T (o - p) but for the sphere; the box's half
# sizes, slab bounds and the normal's divisors max(h, 1e-9); the cylinder's
# r^2, side c, h/2 and cap offsets; the sphere's c
STAGE_FLOPS = {0: 30, 1: 26, 2: 10, 3: 18}
FLOPS_PER_RAY = 31   # world rotation of the ray (quat_rotate), the multiplier
# per hit ray of the normal and RGB modes, by the winner's kind
# (winner_normal; the winner's R^T d is its test's): the hit point, the
# normal (the cylinder's cap branch, whose side branch does 7 more), its
# rotation to world and orientation; the shade on top
NORMAL_FLOPS = {0: 29, 1: 27, 2: 21, 3: 20}
SHADE_FLOPS = 16
# bytes written per ray: depth, + seg, + face and normal, or + rgb
OUT_BYTES_PER_RAY = {"raycast_depth": 4, "raycast_seg": 8, "raycast_normals": 24,
                     "raycast_rgb": 20}
# A/B builds of csrc/raycast.cu beside the shipped -fmad=false: what its
# exact arithmetic costs (K1 at the obstacle path's shapes)
BUILD_AB = {"-fmad=true": ["-fmad=true"],
            "-fmad=false -prec-div=false": ["-fmad=false", "-prec-div=false"]}
# the ray tile of the kernel before its 2-D tiles: 256 consecutive rays,
# whose broad-phase count the timing lines print beside the new one
STRIP_RAYS = 256


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_kernels(build_log: str) -> dict:
    """Registers, spill stores and loads (bytes) and static shared memory
    (bytes) of each kernel in an ``nvcc -Xptxas -v`` log, by its mangled
    symbol (which holds the kernel's name)."""
    out, name = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            out[name] = {}
        elif name is not None:
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out[name].update(registers=int(m.group(1)),
                                 static_smem=int(smem.group(1)) if smem else 0)
    return out


# the keyword arguments of each ray-cast mode
MODE_KW = {"raycast_depth": {"want_seg": False}, "raycast_seg": {},
           "raycast_normals": {"want_normals": True}, "raycast_rgb": {"want_rgb": True}}


def exact_check(torch, rc, args, n_tri, tag, name):
    """One ray-cast mode, the kernel with its broad phase on and off against
    the plain version on the same inputs (``args``: pose, prims, dirs, mult,
    n_box, n_cyl, n_sph, max_range): finite depth, every output equal bit
    for bit (torch.equal), the exact sentinels on a miss and rgb in [0, 1].
    Logs one line and raises on any difference.

    Returns (max_abs_err, the plain version's wall ms, the kernel's outputs)."""
    k = rc.raycast(*args, n_tri=n_tri, **MODE_KW[name])
    k_off = rc.raycast(*args, n_tri=n_tri, cull=False, **MODE_KW[name])
    torch.cuda.synchronize()
    outs = [o for o in k if o is not None]
    cull_same = all(torch.equal(a, b) for a, b in zip(outs, (o for o in k_off if o is not None)))
    del k_off
    t0 = time.perf_counter()
    ref = rc.raycast_reference(*args, n_tri=n_tri, **MODE_KW[name])
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    refs = [o for o in ref if o is not None]
    err = max((a.float() - b.float()).abs().max().item() for a, b in zip(outs, refs))
    exact = all(torch.equal(a, b) for a, b in zip(outs, refs))
    depth, seg = k[0], k[1]
    line = (f"kernel {tag} {name}: {'bit-equal' if exact else 'DIFFER'} (max_abs_err "
            f"{err:.3g}), cull_on{'==' if cull_same else '!='}off")
    sentinels = True
    if seg is not None:
        miss = seg == rc.oracle.NO_HIT_SEGMENTATION_VAL
        if name == "raycast_normals":
            sentinels = bool((k[3][miss] == rc.oracle.NO_HIT_FACE_VAL).all()
                             and (k[2][miss] == 0.0).all())
        elif name == "raycast_rgb":
            sky = torch.as_tensor(rc.oracle.SKY_RGB, device=depth.device)
            sentinels = bool((depth[miss] == rc.oracle.NO_HIT_RAY_VAL).all()
                             and (k[2][miss] == sky).all()
                             and k[2].min().item() >= 0.0 and k[2].max().item() <= 1.0)
        line += f", {int(miss.numel() - miss.sum())} hits, misses with exact sentinels {sentinels}"
    log(line)
    if not (exact and cull_same and sentinels and torch.isfinite(depth).all()):
        raise AssertionError(line)
    del ref, refs, outs
    return err, plain_ms, k


def synthetic_scene(torch, rc, cam_dirs, device, seed=7):
    """Seeded world-frame soup: boxes, cylinders, spheres, 300 triangles
    (324 primitives: more than one shared-memory chunk), ~10% of each kind
    parked at -1000 with zero size like culled obstacles."""
    from aerial_gym_simulator_tpu_torch.utils.math import quat_to_rotation_matrix
    g = torch.Generator(device="cpu").manual_seed(seed)
    N, counts = 8, (12, 8, 4, 300)
    P = sum(counts)
    size = torch.rand((N, P, 3), generator=g) * 1.2 + 0.05
    size[:, counts[0] + counts[1]:counts[0] + counts[1] + counts[2], 1:] = 0.0
    pos = (torch.rand((N, P, 3), generator=g) - 0.5) * 16.0
    q = torch.randn((N, P, 4), generator=g)
    rot = quat_to_rotation_matrix(q / q.norm(dim=-1, keepdim=True))
    sem = torch.randint(0, 50, (N, P), generator=g).float()
    parked = torch.rand((N, P), generator=g) < 0.1
    size[parked] = 0.0
    pos[parked] = -1000.0
    prims = torch.cat([size, pos, rot.reshape(N, P, 9), sem[..., None]], dim=-1)
    qs = torch.randn((N, 4), generator=g)
    pose = rc.pack_pose((torch.rand((N, 3), generator=g) - 0.5) * 4.0,
                        qs / qs.norm(dim=-1, keepdim=True))
    args = (pose.to(device), prims.contiguous().to(device), cam_dirs,
            torch.ones(cam_dirs.shape[:-1], device=device))
    return args, counts


def event_ms(torch, fn, iters):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def windows_ms(torch, runs, iters, n=TIMING_WINDOWS):
    """Each of ``runs`` (name -> fn) after one untimed call, then timed in n
    windows of ``iters`` calls in turns, the order reversed every other
    window -> {name: (median ms, [ms of each window])}."""
    import statistics
    for fn in runs.values():
        fn()
    torch.cuda.synchronize()
    names, times = list(runs), {k: [] for k in runs}
    for w in range(n):
        for name in (names if w % 2 == 0 else names[::-1]):
            times[name].append(event_ms(torch, runs[name], iters))
    return {k: (statistics.median(v), v) for k, v in times.items()}


def spread_text(each):
    return f"{min(each):.3f}-{max(each):.3f} over {len(each)} windows"


def exp_floor_ms(torch, shape):
    """Least time for one exp2 per score (B x H x S^2) on the special-function
    units, 16 a clock on each SM, at the card's highest SM clock."""
    B, S, _, H = shape
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return B * H * S * S / (16.0 * sms * mhz * 1e6) * 1e3


def bound_ms(torch, rc, pose, prims, dirs, counts, n_tri, max_range, name, face=None):
    """Least time for this call's work on the card: the larger of the bytes
    it must move (inputs once, outputs once) over 3.35 TB/s and the f32
    operations over 67 TFLOP/s: each ray's own, the (ray, primitive) tests
    that a broad phase on the primitives' bounding spheres could not skip
    (the ray's half-line meets the sphere within max_range:
    rc.bounding_sphere_hits), whatever the tiling, and the staged constants
    of each (env, primitive) pair among them; for the normal and RGB modes,
    plus the winner's normal (and shade) on each ray that ``face`` says hit.

    Returns (ms, "bytes" or "operations", operations, tests per ray): the
    tests per ray that bound counts ("needed"), and those the kernel's
    broad phase keeps with its 8 x 8 warp patches ("patches") and with the
    256-ray strips of the kernel before them ("strips")."""
    N, P = pose.shape[0], prims.shape[1]
    R = dirs.numel() // 3
    kinds = torch.tensor([rc._kind_of(p, *counts) for p in range(P)], device=dirs.device)
    flops_per_prim = torch.tensor([float(FLOPS_PER_TEST[int(k)]) for k in kinds],
                                  device=dirs.device)
    stage_per_prim = torch.tensor([float(STAGE_FLOPS[int(k)]) for k in kinds],
                                  device=dirs.device)
    groups = {"patches": rc.warp_groups(*rc.ray_grid(dirs), device=dirs.device),
              "strips": torch.arange(R, device=dirs.device) // STRIP_RAYS}
    sizes = {k: torch.bincount(g).float() for k, g in groups.items()}
    ops = float(FLOPS_PER_RAY) * N * R
    tests = {"needed": 0.0, "patches": 0.0, "strips": 0.0}
    for lo in range(0, N, 512):
        ps, pr = pose[lo:lo + 512], prims[lo:lo + 512]
        need = rc.bounding_sphere_hits(ps, pr, dirs, *counts, max_range)        # (n, P)
        ops += float((need * flops_per_prim).sum() + ((need > 0) * stage_per_prim).sum())
        tests["needed"] += float(need.sum())
        for k, g in groups.items():
            vis = rc.tile_visibility(ps, pr, dirs, *counts, max_range, g)      # (n, G, P)
            tests[k] += float((vis.float() * sizes[k][None, :, None]).sum())
    if name in ("raycast_normals", "raycast_rgb"):
        per_prim = torch.tensor([float(NORMAL_FLOPS[int(k)]) for k in kinds], device=dirs.device)
        per_prim += SHADE_FLOPS if name == "raycast_rgb" else 0.0
        for lo in range(0, N, 512):
            f = face[lo:lo + 512]
            ops += float((torch.bincount(f[f >= 0].long(), minlength=P).float()
                          * per_prim).sum())
    n_bytes = 4 * (pose.numel() + prims.numel() + dirs.numel() + R) + N * R * OUT_BYTES_PER_RAY[name]
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return (max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops,
            {k: v / (N * R) for k, v in tests.items()})


def bound_text(b_ms, b_by, ops, tests, ms):
    """The bound, its share and the tests per ray, as every ray-cast timing
    line prints them."""
    return (f"bound {b_ms:.3f} ms by {b_by} ({ops:.4g} f32 ops), share of the bound "
            f"{b_ms / ms:.1%} | tests per ray: {tests['needed']:.2f} needed (bounding sphere "
            f"met in range), {tests['patches']:.2f} kept by the 8x8 warp patches, "
            f"{tests['strips']:.2f} by {STRIP_RAYS}-ray strips")


def products_ms(ops, itemsize):
    """Least time for ``ops`` operations of products: bf16 at the tensor-core
    peak; f32 the faster of f32 multiply-adds (67 TFLOP/s) and three TF32
    products each (3 x ops over 495 TFLOP/s) -> (ms, {route: ms})."""
    if itemsize == 2:
        t = ops / PEAK_BF16_FLOPS * 1e3
        return t, {"bf16 tensor cores": t}
    routes = {"f32 multiply-adds": ops / PEAK_F32_FLOPS * 1e3,
              "3xTF32": 3 * ops / PEAK_TF32_FLOPS * 1e3}
    return min(routes.values()), routes


def bound_of(n_bytes, ops, itemsize):
    """-> (bound ms, "bytes" or "operations", text naming every bound)."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops, routes = products_ms(ops, itemsize)
    text = ", ".join([f"bytes {t_bytes:.3f} ms"] + [f"{k} {v:.3f} ms" for k, v in routes.items()])
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), text


def attention_bound_ms(shape, itemsize):
    """Least time for one attention call: q, k, v in and o out once over
    3.35 TB/s, against the two products' operations (2 x 2 x B x H x S x S
    x head_dim)."""
    B, S, D, H = shape
    return bound_of(4 * B * S * D * itemsize, 4.0 * B * H * S * S * (D // H), itemsize)


def numpy_tensors(torch, shape, dtype, device, n=3, seed=0):
    """n seeded (B, S, D) tensors; ``shape`` is (B, S, D, heads)."""
    import numpy as np
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal(shape[:3]).astype(np.float32))
            .to(device).to(dtype) for _ in range(n)]


def compare_attention(torch, ac, attention_reference, device):
    """K5 against its plain version on the card; returns the largest error
    seen on the bf16 cases (the serving path's type), the error at the
    training path's shape in f32 and the largest error of each kernel family
    (ac.kernel_family)."""
    worst, train_err, by_family = 0.0, None, {f: 0.0 for f in ac.FAMILIES}
    for shape, dtype_name, tol in ATTENTION_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = numpy_tensors(torch, shape, dtype, device)
        out = ac.fused_attention(q, k, v, shape[3])
        ref = attention_reference(q, k, v, shape[3])
        torch.cuda.synchronize()
        if out.dtype != dtype or out.shape != q.shape or not torch.isfinite(out).all():
            raise AssertionError(f"attention {shape} {dtype_name}: bad output")
        diff = (out.float() - ref.float()).abs()
        err = diff.max().item()
        log(f"kernel attention_fwd {shape} {dtype_name}: max_abs_err={err:.3g} "
            f"(atol=rtol={tol})")
        if not bool((diff <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"attention {shape} {dtype_name}: max_abs_err {err}")
        family = ac.kernel_family(shape[2] // shape[3])
        by_family[family] = max(by_family[family], err)
        if dtype_name == "bfloat16":
            worst = max(worst, err)
        elif shape == ATTENTION_TRAIN_SHAPE:
            train_err = err
    q, k, v = numpy_tensors(torch, (2, 32, 128, 4), torch.float32, device)
    try:
        ac.fused_attention(q.transpose(0, 1), k, v, 4)
    except ValueError:
        log("kernel attention_fwd: non-contiguous input refused")
    else:
        raise AssertionError("attention: a non-contiguous input was accepted")
    return worst, train_err, by_family


def attention_counts(ac, **counts):
    """The attention wrapper's launch counts by family: 0, or as given."""
    return {k: counts.get(k, 0) for k in ac.LAUNCHES}


def family_record(name, replaces, launches, rec, errs, ptxas, **subs):
    """The kernels JSON record of the one-pass wide or the cluster kernel
    family (``name``: attention_{fwd,bwd}_{wide,cluster}): its launches on
    its training path, its timing there (``rec``), its largest error there
    and in the comparisons (``errs`` by family), ptxas's numbers for its
    kernels, and sub-records. Where ``rec`` timed the sliced kernels beside
    it on the same tensors (no path launches them), a sub-record of theirs
    carries that time and their largest comparison error."""
    direction, family = name.split("_")[1:]
    if "sliced_ms" in rec:
        subs["sliced_on_the_same_tensors"] = {
            "ms": rec["sliced_ms"], "ms_windows": rec["sliced_ms_windows"], "launches": 0,
            "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
            "max_abs_err": max(rec["sliced_max_abs_err"], errs["_sliced"])}
    kernel = f"attention_{family}_{direction}"          # the source's prefix of its kernels
    return {"name": name, "route": "cuda", "source": ATTENTION_SOURCE, "replaces": replaces,
            "launches": launches[name], **rec,
            "max_abs_err": max(rec["max_abs_err"], errs["_" + family]), **subs,
            "ptxas": {k: v for k, v in ptxas.items() if kernel in k}}


def zero_counts(*counters):
    for c in counters:
        for k in c:
            c[k] = 0


def wall_ms(torch, fn, iters=3):
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t) / iters * 1e3


def fly(torch, task, policy, steps, recurrent=False):
    """Closed loop: policy(obs) -> task.step, outcomes summed on the device;
    a recurrent policy's hidden state is zeroed where an episode ended."""
    obs, *_ = task.reset()
    totals = torch.zeros(3, device=task.device)
    finite = torch.ones((), dtype=torch.bool, device=task.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        act = policy(obs["observations"])
        obs, rew, term, trunc, info = task.step(act)
        if recurrent:
            policy.reset((term > 0) | (trunc > 0))
        totals += torch.stack([info["successes"].sum(), info["crashes"].sum(),
                               info["timeouts"].sum()])
        finite &= (torch.isfinite(act).all() & torch.isfinite(rew).all()
                   & torch.isfinite(obs["observations"]).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("non-finite action, reward or observation in the nav loop")
    if obs["observations"].shape != (task.num_envs, task.task_config.observation_space_dim):
        raise AssertionError(f"observation shape {tuple(obs['observations'].shape)}")
    return dt, [float(x) for x in totals]


def nav_phase(torch, port, rc, ac, card):
    """The navigation task at full width through task_registry.make_task,
    flown by the shipped networks. Returns the kernels' launch counts from
    the ViT run and the task (for the timing phase)."""
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs, render_camera
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
    from aerial_gym_simulator_tpu_torch.tasks import navigation_task as nav

    def make(encoder_file):
        cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                                  vae_params_path=str(NETWORKS / encoder_file))
        return port.task_registry.make_task("navigation_task", num_envs=NAV_ENVS, seed=99,
                                            task_config=cfg)

    t0 = time.perf_counter()
    task = make("vit_depth_encoder.pkl")
    policy = load_policy_npz(str(NETWORKS / "vit_navigation_policy.npz"))
    torch.cuda.synchronize()
    enc = task.vae.encoder
    if not isinstance(task.vae, ViTImageEncoder) or enc.blocks[0].attn.impl != "fused":
        raise AssertionError("the shipped ViT checkpoint did not route to the fused encoder")
    log(f"nav: make_task({NAV_ENVS} envs, lmf2, ViT dim {enc.latent_head.in_features} "
        f"depth {len(enc.blocks)} heads {enc.blocks[0].attn.num_heads}, "
        f"{task.vae.compute_dtype}) {time.perf_counter() - t0:.2f} s")
    fly(torch, task, policy, 3)                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    dt, (succ, crash, timo) = fly(torch, task, policy, NAV_STEPS)
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    ended = succ + crash + timo
    log(f"nav: ViT loop {NAV_STEPS * NAV_ENVS / dt:.1f} env-steps/s "
        f"({dt / NAV_STEPS * 1e3:.2f} ms/step) | {card}")
    succ_share = succ / max(ended, 1.0)
    log(f"nav: launches {launches}, successes {succ:.0f} crashes {crash:.0f} "
        f"timeouts {timo:.0f} (success share {succ_share:.3f}), curriculum level "
        f"{float(task.nav_state.curriculum_level):.0f}, peak memory {peak_gb:.2f} GB")
    want = {"raycast_depth": NAV_STEPS, "raycast_seg": 0, "raycast_normals": 0,
            "raycast_rgb": 0, **attention_counts(ac, attention_fwd=4 * NAV_STEPS)}
    if launches != want:
        raise AssertionError(f"nav launches {launches}, expected {want}")
    if not (succ > 0 and succ_share > NAV_SUCCESS_SHARE):
        raise AssertionError(f"success share {succ}/{ended} not above {NAV_SUCCESS_SHARE}")

    # where the step's time goes: its pieces timed apart on the final state
    ns, params, cfg = task.nav_state, task.params, task.task_config
    obs = task.task_obs["observations"]
    action = nav.action_transform(cfg, policy(obs))
    pixels, _ = render_camera(params, ns.sim, want_seg=False)
    none_done = torch.zeros(NAV_ENVS, device=task.device)
    parts = {
        "env_step": lambda: dynamics.env_step(params, ns.sim, action),
        "reset_envs": lambda: dynamics.reset_envs(params, ns.sim, none_done),
        "render": lambda: render_camera(params, ns.sim, want_seg=False),
        "encode": lambda: task.vae.encode(pixels, generator=ns.rng),
        "policy": lambda: policy(obs),
        "task.step": lambda: task.step(action),
    }
    split = {name: wall_ms(torch, fn, 5) for name, fn in parts.items()}
    log("nav: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" (task.step = env_step + reset_envs + render + encode + reward, observation "
        f"and curriculum) | {card}")
    lat_err = encoder_against_plain(torch, ac, task.vae, pixels)

    # K1 at this path's shapes against its plain version, on the final state
    sp, sc, st = params.camera, params.scene, ns.sim
    args = cast_inputs(params, st, sp, st.cam_mount_pos, st.cam_mount_quat)
    k1_ms = event_ms(torch, lambda: rc.raycast(*args, want_seg=False, n_tri=sc.n_tri), 10)
    k1_err = exact_check(torch, rc, args, sc.n_tri, "nav", "raycast_depth")[0]
    log(f"nav: raycast_depth at this path's shapes ({NAV_ENVS}x{sp.height}x{sp.width} rays, "
        f"{args[1].shape[1]} prims, curriculum-culled scene): kernel {k1_ms:.3f} ms | {card}")
    del task, parts, pixels, obs, args

    # the task's default perception path: the conv VAE and its policy
    conv_task = make("depth_vae.pkl")
    conv_policy = load_policy_npz(str(NETWORKS / "navigation_policy.npz"))
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    dt, (succ, crash, timo) = fly(torch, conv_task, conv_policy, NAV_CONV_STEPS)
    conv_launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    log(f"nav: conv VAE loop {NAV_CONV_STEPS * NAV_ENVS / dt:.1f} env-steps/s "
        f"({dt / NAV_CONV_STEPS * 1e3:.2f} ms/step), launches {conv_launches}, "
        f"successes {succ:.0f} crashes {crash:.0f} timeouts {timo:.0f} | {card}")
    want = {"raycast_depth": NAV_CONV_STEPS, "raycast_seg": 0, "raycast_normals": 0,
            "raycast_rgb": 0, **attention_counts(ac)}
    if conv_launches != want:
        raise AssertionError(f"conv nav launches {conv_launches}, expected {want}")
    conv_task.close()
    return launches, k1_err, {"success_share": succ_share, "latent_err_vs_reference": lat_err}


def encoder_against_plain(torch, ac, vae, pixels):
    """The nav run's depth images encoded by the flown encoder (bf16, the
    fused kernel) and by the same pickle re-tagged "reference" (the plain
    attention, no kernel launch): the latent means within the bf16 bar of
    tests/test_torch_models.py (atol 0.05 + rtol 0.05)."""
    import pickle
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    from aerial_gym_simulator_tpu_torch.sim.convert import load_encoder_pickle
    with open(NETWORKS / "vit_depth_encoder.pkl", "rb") as f:
        blob = pickle.load(f)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "vit_reference.pkl")
        with open(path, "wb") as f:
            pickle.dump(dict(blob, attn_impl="reference"), f)
        _, enc = load_encoder_pickle(path)
    plain = ViTImageEncoder(latent_dim=vae.latent_dim, image_res=vae.image_res, encoder=enc,
                            patch=enc.patch)
    if enc.blocks[0].attn.impl != "reference" or plain.input_hw != vae.input_hw:
        raise AssertionError("the reference-tagged encoder does not match the flown one")
    zero_counts(ac.LAUNCHES)
    fused = vae.encode_moments(pixels)[0]
    fused_launches = dict(ac.LAUNCHES)
    zero_counts(ac.LAUNCHES)
    ref = plain.encode_moments(pixels)[0]
    torch.cuda.synchronize()
    if fused_launches != attention_counts(ac, attention_fwd=4) or any(ac.LAUNCHES.values()):
        raise AssertionError(f"encoder launches: fused {fused_launches}, plain {ac.LAUNCHES}")
    diff = (fused - ref).abs()
    err = diff.max().item()
    log(f"nav: the flown ViT encoder (fused kernel, 4 launches) against its pickle re-tagged "
        f"'reference' (plain attention) on the run's {pixels.shape[0]} depth images: latent "
        f"means within {err:.3g} (bar atol 0.05 + rtol 0.05)")
    if not (torch.isfinite(fused).all() and bool((diff <= 0.05 + 0.05 * ref.abs()).all())):
        raise AssertionError(f"fused against plain encoder: latents differ by {err}")
    return err


def parent_launchers(torch, lib, source):
    """The launchers of another build of ``csrc/attention.cu``
    (``--parent-attention``: the parent commit's source, for a comparison
    inside one call) -> (fwd, bwd). fwd(q, k, v, H, kernel, want_lse) -> o,
    or (o, L), with ``kernel`` as attention_fwd_launch takes it (1: the bf16
    serving kernels); bwd(q, k, v, o, L, do, H) -> (dq, dk, dv) through the
    kernels of the head size's family. Each raises where that build's launch
    fails. attention_bwd_launch's parameters are read off the source: with 18
    it takes a kernel choice (0: by head size) before the stream."""
    import ctypes
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    so = lib.load()
    so.attention_fwd_launch.argtypes = [p, p, p, p, p, i, i, i, i, f, i, i, p]
    so.attention_fwd_launch.restype = i
    params = re.search(r'extern "C" int attention_bwd_launch\(([^)]*)\)',
                       Path(source).read_text()).group(1).count(",") + 1
    kernel_arg = [0] if params == 18 else []
    so.attention_bwd_launch.argtypes = [p] * 10 + [i, i, i, i, f, i] + [i] * len(kernel_arg) + [p]
    so.attention_bwd_launch.restype = i
    so.attention_error_string.argtypes = [i]
    so.attention_error_string.restype = ctypes.c_char_p

    def check(code):
        if code != 0:
            raise RuntimeError("parent build: " + so.attention_error_string(code).decode())

    def fwd(q, k, v, H, kernel=0, want_lse=False):
        B, S, D = q.shape
        o = torch.empty_like(q)
        lse = torch.empty((B, H, S), device=q.device, dtype=torch.float32) if want_lse else None
        check(so.attention_fwd_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                      lse.data_ptr() if want_lse else None, B, S, H, D // H,
                                      float((D // H) ** -0.5), int(q.dtype == torch.bfloat16),
                                      kernel, torch.cuda.current_stream().cuda_stream))
        return (o, lse) if want_lse else o

    def bwd(q, k, v, o, lse, do, H):
        B, S, D = q.shape
        grads = [torch.empty_like(q) for _ in range(3)]
        delta = torch.empty_like(lse)
        check(so.attention_bwd_launch(*(x.data_ptr() for x in (q, k, v, o, do, lse, delta, *grads)),
                                      B, S, H, D // H, float((D // H) ** -0.5),
                                      int(q.dtype == torch.bfloat16), *kernel_arg,
                                      torch.cuda.current_stream().cuda_stream))
        return grads
    return fwd, bwd


# (name, (B, S, D, heads), dtype name, the shipped wrapper's keyword
# arguments, the parent launcher's kernel, timed): kernels this source keeps
# as its parent had them, at their main paths' shapes (timed) and at two
# small ones (bits only: a call of tens of microseconds times the wrapper's
# host work against the parent's bare launch, not the kernel)
PARENT_CASES = [
    ("narrow TF32, head_dim 32", ATTENTION_TRAIN_SHAPE, "float32", {}, 0, True),
    ("narrow TF32, head_dim 64", (TRAIN_BATCH, 225, 256, 4), "float32", {}, 0, True),
    ("narrow TF32 in bf16, head_dim 128", (8, 225, 256, 2), "bfloat16", {}, 0, False),
    ("staged serving, head_dim 32", ATTENTION_MAIN_SHAPE, "bfloat16", {}, 1, True),
    ("ring serving, head_dim 64", SERVING_HD64_SHAPE, "bfloat16", {}, 1, True),
    ("ring forced, head_dim 32", ATTENTION_MAIN_SHAPE, "bfloat16", {"use_mma": True, "ring": True},
     3, True),
    ("one-pass wide, head_dim 256", WIDE_HEAD_SHAPE, "float32", {}, 0, True),
    ("one-pass wide, head_dim 256", WIDE_SERVING_SHAPE, "bfloat16", {}, 0, True),
    ("one-pass wide, head_dim 136", (4, 65, 272, 2), "float32", {}, 0, False),
]


def parent_compare(torch, ac, parent_fwd, parent_bwd, device, card):
    """The narrow, staged, ring and one-pass wide kernels against the parent
    build's on the same numpy-seeded tensors: the forward (with L, and for
    the serving kernels without it too) and the backward from the same o
    and L, each output bit for bit (torch.equal); then, at the main paths'
    shapes, the forward as its path calls it (the serving kernels without
    L) and the backward, each timed in turns with the parent's (medians of
    alternating windows)."""
    for name, shape, dtype_name, kw, kernel, timed_here in PARENT_CASES:
        H = shape[3]
        q, k, v, do = numpy_tensors(torch, shape, getattr(torch, dtype_name), device, n=4, seed=3)
        pairs = []
        if kernel != 0:              # the serving kernels: without L, as the nav path runs them
            pairs.append(("o", ac.attention_forward(q, k, v, H, **kw),
                          parent_fwd(q, k, v, H, kernel)))
        out, lse = ac.attention_forward(q, k, v, H, want_lse=True, **kw)
        p_out, p_lse = parent_fwd(q, k, v, H, kernel, want_lse=True)
        pairs += [("o with L", out, p_out), ("L", lse, p_lse)]
        grads = ac.attention_backward(q, k, v, do, H, out=out, lse=lse)
        pairs += list(zip(("dq", "dk", "dv"), grads, parent_bwd(q, k, v, out, lse, do, H)))
        torch.cuda.synchronize()
        differ = [what for what, a, b in pairs if not torch.equal(a, b)]
        del pairs, grads, p_out, p_lse
        times = "not timed (a launch-bound shape)"
        if timed_here:
            want_lse = kernel == 0
            iters = 20 if shape[0] <= TRAIN_BATCH else 5
            fwd = windows_ms(torch, {
                "shipped": lambda: ac.attention_forward(q, k, v, H, want_lse=want_lse, **kw),
                "parent": lambda: parent_fwd(q, k, v, H, kernel, want_lse=want_lse)}, iters)
            bwd = windows_ms(torch, {
                "shipped": lambda: ac.attention_backward(q, k, v, do, H, out=out, lse=lse),
                "parent": lambda: parent_bwd(q, k, v, out, lse, do, H)}, iters)
            times = "; ".join(
                f"{what} {t['shipped'][0]:.3f} ms ({spread_text(t['shipped'][1])}), parent "
                f"{t['parent'][0]:.3f} ({spread_text(t['parent'][1])}), "
                f"{t['shipped'][0] / t['parent'][0] - 1.0:+.1%}"
                for what, t in (("forward" + (" with L" if want_lse else ""), fwd),
                                ("backward from o and L", bwd)))
        log(f"kernel {name} {shape} {dtype_name} against the parent build: "
            f"{'DIFFER in ' + ', '.join(differ) if differ else 'o, L, dq, dk, dv bit-equal'}; "
            f"{times} | {card}")
        if differ:
            raise AssertionError(f"{name} {shape} {dtype_name}: {differ} differ from the parent")
        del q, k, v, do, out, lse
    torch.cuda.empty_cache()


def time_attention(torch, ac, attention_reference, card, shape, dtype_name, tol, parent=None):
    """K5 at one path's shape and type: kernel, plain version, the library's
    fused attention on the same tensors, the bound and the exp floor; kernel
    and library (and ``parent``, the parent commit's serving kernel, where
    given and the shape runs a serving kernel, the ring kernel forced at
    head_dim 32, and the sliced kernel at the one-pass wide and the cluster
    kernels' head sizes) as medians of alternating windows after one untimed
    call each. bf16 at head_dim 32 or 64 runs a bf16 serving kernel (the staged
    one at head_dim 32 while it holds the sequence, else the ring), f32 the
    TF32 kernel (3xTF32)."""
    import torch.nn.functional as F
    B, S, D, H = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((B, S, D), generator=g, device="cuda").to(dtype)
               for _ in range(3))
    heads = lambda x: x.view(B, S, H, D // H).transpose(1, 2)
    run = lambda: ac.fused_attention(q, k, v, H)
    lib_run = lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    runs, extra, other = {"kernel": run, "library": lib_run}, {}, ""
    serving = dtype_name == "bfloat16" and D // H in ac.MMA_HEAD_DIMS
    ring = lambda: ac.attention_forward(q, k, v, H, use_mma=True, ring=True)
    if serving and D // H == 32:
        runs["ring"] = ring          # where the launcher may pick the staged kernel
    if serving and parent is not None:
        try:
            parent(q, k, v, H)
        except RuntimeError as e:      # past the parent's shared-memory limit
            extra["parent"] = f"refused ({e})"
            other = f"parent kernel refused ({e}), "
        else:
            runs["parent"] = lambda: parent(q, k, v, H)
    if ac.kernel_family(D // H) in ("_wide", "_cluster"):
        # the sliced kernel that the one-pass wide or the cluster kernel
        # replaced, on the same tensors
        runs["sliced"] = lambda: ac.attention_forward(q, k, v, H, sliced=True)
    t = windows_ms(torch, runs, 20)
    (ms, each), (lib_ms, lib_each) = t["kernel"], t["library"]
    plain_ms = event_ms(torch, lambda: attention_reference(q, k, v, H), 3)
    if serving:
        # the source's other kernel (TF32 products) on the same tensors
        tf32_ms = event_ms(torch, lambda: ac.attention_forward(q, k, v, H, use_mma=False), 3)
        other += f"TF32 kernel {tf32_ms:.3f} ms, "
    if "sliced" in t:
        # held to the same tolerance
        ref = attention_reference(q, k, v, H).float()
        sliced_err = (runs["sliced"]().float() - ref).abs()
        if not bool((sliced_err <= tol + tol * ref.abs()).all()):
            raise AssertionError(f"sliced attention at {shape} {dtype_name}: max_abs_err "
                                 f"{sliced_err.max().item()}")
        extra.update(sliced_ms=t["sliced"][0], sliced_ms_windows=t["sliced"][1],
                     sliced_max_abs_err=sliced_err.max().item())
        other = (f"sliced kernel {t['sliced'][0]:.3f} ms ({spread_text(t['sliced'][1])}; "
                 f"max_abs_err {sliced_err.max().item():.3g}), ")
    out, ref = run(), attention_reference(q, k, v, H)
    lib = lib_run().transpose(1, 2)
    torch.cuda.synchronize()
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    lib_err = (lib.reshape(B, S, D).float() - ref.float()).abs().max().item()
    if not bool((diff <= tol + tol * ref.float().abs()).all()):
        raise AssertionError(f"attention at {shape} {dtype_name}: max_abs_err {err}")
    if "ring" in t:
        ring_diff = (ring().float() - ref.float()).abs()
        if not bool((ring_diff <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"ring kernel at {shape}: max_abs_err {ring_diff.max().item()}")
        extra.update(ring_ms=t["ring"][0], ring_ms_windows=t["ring"][1],
                     ring_max_abs_err=ring_diff.max().item())
        other = (f"ring kernel {t['ring'][0]:.3f} ms ({spread_text(t['ring'][1])}; max_abs_err "
                 f"{ring_diff.max().item():.3g}), ") + other
    if "parent" in t:
        par_diff = (parent(q, k, v, H).float() - ref.float()).abs()
        if not bool((par_diff <= tol + tol * ref.float().abs()).all()):
            raise AssertionError(f"parent kernel at {shape}: max_abs_err {par_diff.max().item()}")
        extra.update(parent_ms=t["parent"][0], parent_ms_windows=t["parent"][1],
                     parent_max_abs_err=par_diff.max().item())
        other = (f"parent kernel {t['parent'][0]:.3f} ms ({spread_text(t['parent'][1])}; "
                 f"max_abs_err {par_diff.max().item():.3g}), ") + other
    b_ms, b_by, bounds = attention_bound_ms(shape, q.element_size())
    floor = exp_floor_ms(torch, shape)
    log(f"timing attention_fwd {shape} {dtype_name}: kernel {ms:.3f} ms ({spread_text(each)}), "
        f"plain {plain_ms:.2f} ms, {other}scaled_dot_product_attention {lib_ms:.3f} ms "
        f"({spread_text(lib_each)}; its max_abs_err {lib_err:.3g}), max_abs_err {err:.3g} | "
        f"bound {b_ms:.3f} ms by {b_by} ({bounds}); share of the bound {b_ms / ms:.1%}, "
        f"library's {b_ms / lib_ms:.1%}; exp floor {floor:.3f} ms (B H S^2 exp2 at 16 a clock "
        f"per SM) | {card}")
    return {"ms": ms, "ms_windows": each, "plain_ms": plain_ms, "library_ms": lib_ms,
            "library_ms_windows": lib_each, "bound_ms": b_ms, "bound_by": b_by,
            "exp_floor_ms": floor, "max_abs_err": err, **extra}


def attention_bwd_bound_ms(shape, itemsize):
    """Least time for one attention backward: q, k, v, do in and dq, dk, dv
    out once over 3.35 TB/s, against five products' operations (5 x 2 x B x
    H x S x S x head_dim)."""
    B, S, D, H = shape
    return bound_of(7 * B * S * D * itemsize, 10.0 * B * H * S * S * (D // H), itemsize)


def compare_attention_bwd(torch, ac, attention_backward_reference, device):
    """K6 against its plain version on the card, and against itself: two
    launches on the same inputs must give the same bits. Returns the largest
    error at the training shape (f32, the main path's type) and the largest
    error of each kernel family (ac.kernel_family)."""
    main_err, by_family = 0.0, {f: 0.0 for f in ac.FAMILIES}
    for shape, dtype_name, tol in ATTENTION_BWD_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v, do = numpy_tensors(torch, shape, dtype, device, n=4, seed=1)
        got = ac.attention_backward(q, k, v, do, shape[3])
        again = ac.attention_backward(q, k, v, do, shape[3])
        want = attention_backward_reference(q, k, v, do, shape[3])
        torch.cuda.synchronize()
        worst = 0.0
        for name, a, a2, b in zip(("dq", "dk", "dv"), got, again, want):
            if a.dtype != dtype or a.shape != q.shape or not torch.isfinite(a).all():
                raise AssertionError(f"attention_bwd {shape} {dtype_name}: bad {name}")
            if not torch.equal(a, a2):
                raise AssertionError(f"attention_bwd {shape} {dtype_name}: two launches "
                                     f"differ in {name}")
            diff = (a.float() - b.float()).abs()
            worst = max(worst, diff.max().item())
            if not bool((diff <= tol + tol * b.float().abs()).all()):
                raise AssertionError(f"attention_bwd {shape} {dtype_name}: {name} "
                                     f"max_abs_err {diff.max().item()}")
        log(f"kernel attention_bwd {shape} {dtype_name}: max_abs_err={worst:.3g} "
            f"(atol=rtol={tol}), second launch bit-equal")
        if shape == ATTENTION_TRAIN_SHAPE:
            main_err = worst
        family = ac.kernel_family(shape[2] // shape[3])
        by_family[family] = max(by_family[family], worst)
        del q, k, v, do, got, again, want
    torch.cuda.empty_cache()
    # the adversarial case: q and k scaled by 30, gradients must stay finite
    q, k, v, do = numpy_tensors(torch, (1, 96, 64, 2), torch.float32, device, n=4, seed=4)
    for g in ac.attention_backward(q * 30.0, k * 30.0, v, do, 2):
        if not torch.isfinite(g).all():
            raise AssertionError("attention_bwd: non-finite gradient at large logits")
    log("kernel attention_bwd: finite at logits of order 1e3")
    return main_err, by_family


def device_ms_by_kernel(torch, fn, names, iters=10):
    """Device time per call of fn of each kernel whose symbol holds one of
    ``names``, from torch.profiler's CUDA activity; None where the trace
    shows no device time for it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    return {name: (sum(e.device_time_total for e in events if name in e.key) / iters / 1e3
                   or None) for name in names}


def device_busy(torch, fn, iters):
    """(wall ms, device-busy ms) per call of an already warmed-up fn: the
    device time of every kernel and copy in torch.profiler's CUDA activity
    (one stream: they do not overlap) against the host clock around the
    calls, which includes the profiler's own host cost."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = sum(e.device_time_total for e in prof.key_averages()) / 1e3
    return wall / iters * 1e3, busy / iters


def busy_text(wall_ms, busy_ms):
    return (f"device busy {busy_ms:.2f} of {wall_ms:.2f} ms (idle share "
            f"{1.0 - busy_ms / wall_ms:.3f}, under torch.profiler)")


def time_attention_bwd(torch, ac, attention_backward_reference, card, shape, dtype_name, tol):
    """K6 at one shape: the kernels as autograd runs them (from the
    forward's output and L, as the library's backward has its own), the
    whole direct call (a forward launch to make them, then the backward),
    the plain backward, the backward of the library's fused attention on the
    same tensors, and the bound; each gradient held against the plain one
    at atol = rtol = tol. For the one-pass wide and the cluster kernels also
    each kernel's device time; for the cluster kernels also the sliced
    kernels from o and L on the same tensors, held to the same tolerance."""
    import torch.nn.functional as F
    B, S, D, H = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device="cuda").manual_seed(6)
    q, k, v, do = (torch.randn((B, S, D), generator=g, device="cuda").to(dtype)
                   for _ in range(4))
    heads = lambda x: x.view(B, S, H, D // H).transpose(1, 2)
    lq, lk, lv = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
    lib_out = F.scaled_dot_product_attention(lq, lk, lv)
    lib_do = heads(do)
    out, lse = ac.attention_forward(q, k, v, H, want_lse=True)
    run = lambda: ac.attention_backward(q, k, v, do, H, out=out, lse=lse)
    lib = lambda: torch.autograd.grad(lib_out, (lq, lk, lv), lib_do, retain_graph=True)
    iters = 20 if B <= 64 else 5
    runs, family = {"kernel": run, "library": lib}, ac.kernel_family(D // H)
    if family == "_cluster":
        # the sliced kernels that the cluster kernels replaced, on the same tensors
        runs["sliced"] = lambda: ac.attention_backward(q, k, v, do, H, out=out, lse=lse,
                                                       sliced=True)
    t = windows_ms(torch, runs, iters)
    (ms, each), (lib_ms, lib_each) = t["kernel"], t["library"]
    direct_ms = event_ms(torch, lambda: ac.attention_backward(q, k, v, do, H), iters)
    plain_ms = event_ms(torch, lambda: attention_backward_reference(q, k, v, do, H), 3)
    split = {}
    if family in ("_wide", "_cluster"):
        split = dict(zip(("dq_kernel_ms", "dkdv_kernel_ms"), device_ms_by_kernel(
            torch, run, (f"{family[1:]}_bwd_dq", f"{family[1:]}_bwd_dkdv")).values()))
    got, want, lib_g = run(), attention_backward_reference(q, k, v, do, H), lib()
    torch.cuda.synchronize()

    def worst_error(grads, what):
        worst = 0.0
        for name, a, b in zip(("dq", "dk", "dv"), grads, want):
            diff = (a.float() - b.float()).abs()
            worst = max(worst, diff.max().item())
            if not bool((diff <= tol + tol * b.float().abs()).all()):
                raise AssertionError(f"{what} at {shape} {dtype_name}: {name} "
                                     f"max_abs_err {diff.max().item()}")
        return worst

    err = worst_error(got, "attention_bwd")
    if "sliced" in t:
        split.update(sliced_ms=t["sliced"][0], sliced_ms_windows=t["sliced"][1],
                     sliced_max_abs_err=worst_error(runs["sliced"](), "sliced attention_bwd"))
    lib_err = max((a.transpose(1, 2).reshape(B, S, D).float() - b.float()).abs().max().item()
                  for a, b in zip(lib_g, want))
    itemsize = 2 if dtype_name == "bfloat16" else 4
    b_ms, b_by, bounds = attention_bwd_bound_ms(shape, itemsize)
    log(f"timing attention_bwd {shape} {dtype_name}: kernels from o and L {ms:.3f} ms "
        f"({spread_text(each)}){f' {split}' if split else ''}, whole direct call "
        f"{direct_ms:.3f} ms, plain {plain_ms:.2f} ms, scaled_dot_product_attention backward "
        f"{lib_ms:.3f} ms ({spread_text(lib_each)}; its max_abs_err {lib_err:.3g}), max_abs_err "
        f"{err:.3g} | bound {b_ms:.3f} ms by {b_by} ({bounds}); share of the bound "
        f"{b_ms / ms:.1%}, library's {b_ms / lib_ms:.1%} | {card}")
    return {"ms": ms, "ms_windows": each, "direct_ms": direct_ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "library_ms_windows": lib_each, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, **split}


def flash_phase(torch, ac, attention_reference, card):
    """The JAX package's "flash" attention as the port runs it (K7: the f32
    fused kernel on f32 copies, the result cast back). Times it at the
    serving shape beside the plain version, the library's fused attention on
    the same f32 copies and the bound, then serves the shipped ViT encoder
    re-tagged "flash" on 1,024 images: four forward launches per encode and
    the "fused" pickle's latents within the bf16 bar."""
    import pickle
    import torch.nn.functional as F
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    from aerial_gym_simulator_tpu_torch.sim.convert import load_encoder_pickle
    B, S, D, H = ATTENTION_MAIN_SHAPE
    g = torch.Generator(device="cuda").manual_seed(7)
    q, k, v = (torch.randn((B, S, D), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    heads = lambda x: x.view(B, S, H, D // H).transpose(1, 2)
    qf, kf, vf = q.float(), k.float(), v.float()
    flash = lambda: ac.fused_attention(q.float(), k.float(), v.float(), H).to(q.dtype)
    kernel = lambda: ac.fused_attention(qf, kf, vf, H)
    lib_run = lambda: F.scaled_dot_product_attention(heads(qf), heads(kf), heads(vf))
    ms_a, lib_a = event_ms(torch, kernel, 20), event_ms(torch, lib_run, 20)
    lib_b, ms_b = event_ms(torch, lib_run, 20), event_ms(torch, kernel, 20)
    flash_ms = event_ms(torch, flash, 20)
    plain_ms = event_ms(torch, lambda: attention_reference(qf, kf, vf, H), 3)
    out, ref = kernel(), attention_reference(qf, kf, vf, H)
    torch.cuda.synchronize()
    diff = (out - ref).abs()
    err = diff.max().item()
    if not bool((diff <= 1e-4 + 1e-4 * ref.abs()).all()):
        raise AssertionError(f"flash path: max_abs_err {err}")
    b_ms, b_by, bounds = attention_bound_ms(ATTENTION_MAIN_SHAPE, 4)
    ms, lib_ms = min(ms_a, ms_b), min(lib_a, lib_b)
    log(f"timing flash path {ATTENTION_MAIN_SHAPE} bf16 -> f32: kernel {ms:.3f} ms ({ms_a:.3f}, "
        f"{ms_b:.3f}), with the casts {flash_ms:.3f} ms, plain {plain_ms:.2f} ms, "
        f"scaled_dot_product_attention on the f32 copies {lib_ms:.3f} ms ({lib_a:.3f}, "
        f"{lib_b:.3f}), max_abs_err {err:.3g} | bound {b_ms:.3f} ms by {b_by} ({bounds}); "
        f"share of the bound {b_ms / ms:.1%}, library's {b_ms / lib_ms:.1%} | {card}")
    del q, k, v, qf, kf, vf, out, ref

    with open(NETWORKS / "vit_depth_encoder.pkl", "rb") as f:
        blob = pickle.load(f)
    images = torch.rand((NAV_ENVS, 135, 240), generator=g, device="cuda")
    latents = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag in ("fused", "flash"):
            path = os.path.join(tmp, f"vit_{tag}.pkl")
            with open(path, "wb") as f:
                pickle.dump(dict(blob, attn_impl=tag), f)
            _, enc = load_encoder_pickle(path)
            served = ViTImageEncoder(latent_dim=64, image_res=(135, 240), encoder=enc,
                                     patch=enc.patch)
            if enc.blocks[0].attn.impl != tag:
                raise AssertionError(f"the {tag!r} pickle loaded as {enc.blocks[0].attn.impl!r}")
            served.encode(images)                               # warm-up
            torch.cuda.synchronize()
            zero_counts(ac.LAUNCHES)
            latents[tag] = served.encode(images)
            torch.cuda.synchronize()
            launches = dict(ac.LAUNCHES)
            if launches != attention_counts(ac, attention_fwd=4):
                raise AssertionError(f"{tag} encoder launches {launches}")
    lat_err = (latents["flash"] - latents["fused"]).abs().max().item()
    log(f"flash: the shipped ViT encoder re-tagged 'flash' served on {NAV_ENVS} images (bf16, "
        f"attention in f32 through the kernel, 4 launches per encode): latents within "
        f"{lat_err:.3g} of the 'fused' pickle's")
    if not bool(((latents["flash"] - latents["fused"]).abs()
                 <= 0.05 + 0.05 * latents["fused"].abs()).all()):
        raise AssertionError(f"flash-tagged encoder: latents differ by {lat_err}")
    return {"ms": ms, "ms_with_casts": flash_ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": b_ms, "bound_by": b_by, "max_abs_err": err, "launches": 4,
            "latent_err_vs_fused": lat_err}


def timed(torch, fn):
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def train_vit(torch, rc, ac, card, argv, steps, want_attention):
    """models/train_vae --arch vit at full width through the functions its
    main calls (build_parser, train) for ``steps`` steps: finite loss that
    falls (the mean of the last 5 below the first), K1 once per step and the
    attention launches ``want_attention`` (family -> launches per step).
    Returns (model, args, launches, the loss of every step)."""
    from aerial_gym_simulator_tpu_torch.models import train_vae
    from aerial_gym_simulator_tpu_torch.models.vit import DepthViT

    args = train_vae.build_parser().parse_args(argv + ["--steps", str(steps)])
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    t0 = time.perf_counter()
    model, history = train_vae.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    losses = [h["loss"] for h in history]
    if not isinstance(model, DepthViT) or len(losses) != steps:
        raise AssertionError(f"train_vae returned {type(model).__name__}, {len(losses)} logs")
    if not all(math.isfinite(h[k]) for h in history for k in ("loss", "bce", "kld")):
        raise AssertionError(f"train_vae: non-finite loss in {losses}")
    last = sum(losses[-5:]) / 5.0
    n_params = sum(p.numel() for p in model.parameters())
    steady = (history[-1]["wall_s"] - history[4]["wall_s"]) / (steps - 5) * 1e3
    log(f"train: train_vae --arch vit --vit_attn fused dim {args.vit_dim} depth {args.vit_depth} "
        f"heads {args.vit_heads}, batch {args.batch}, {args.image_h}x{args.image_w}, f32, "
        f"{n_params / 1e6:.2f}M parameters: {steps} steps in {wall:.2f} s incl. set-up, "
        f"{steady:.2f} ms/step after the first 5 | {card}")
    log(f"train: loss {losses[0]:.5f} -> {last:.5f} (mean of the last 5; bce "
        f"{history[-1]['bce']:.5f}, kld {history[-1]['kld']:.4f}), launches {launches}, "
        f"peak memory {peak_gb:.2f} GB")
    if not last < losses[0]:
        raise AssertionError(f"train_vae: loss did not fall: {losses[0]} -> {last}")
    want = {"raycast_depth": steps, "raycast_seg": 0, "raycast_normals": 0, "raycast_rgb": 0,
            **attention_counts(ac, **{k: n * steps for k, n in want_attention.items()})}
    if launches != want:
        raise AssertionError(f"train launches {launches}, expected {want}")
    return model, args, launches, losses


def step_split(torch, model, args, env, state, card, tag):
    """Where a train_vae step's time goes: its four pieces, synchronised
    apart, on fresh renders of ``env``; logs them with the peak memory."""
    from aerial_gym_simulator_tpu_torch.models import train_vae
    from aerial_gym_simulator_tpu_torch.models.vae import vae_loss

    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    hw = (args.image_h, args.image_w)
    split = {"sample+render": 0.0, "forward": 0.0, "backward": 0.0, "optimizer": 0.0}
    reps = 5
    torch.cuda.reset_peak_memory_stats()
    for rep in range(reps + 1):
        with torch.no_grad():
            (state, batch, targets), t_s = timed(
                torch, lambda: train_vae.sample_batch(env.params, state, hw))
        optimizer.zero_grad(set_to_none=True)
        (loss, _), t_f = timed(torch, lambda: vae_loss(model, batch, generator=gen,
                                                        targets=targets))
        _, t_b = timed(torch, loss.backward)
        _, t_o = timed(torch, optimizer.step)
        if rep:                                            # the first pass warms up
            for name, t in zip(split, (t_s, t_f, t_b, t_o)):
                split[name] += t / reps
    log(f"train{tag}: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" = {sum(split.values()):.2f} ms/step, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
    return split


def train_phase(torch, rc, ac, card):
    """models/train_vae at full width through the functions its main calls;
    returns the kernels' launch counts from the ViT run."""
    from aerial_gym_simulator_tpu_torch.models import train_vae
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    from aerial_gym_simulator_tpu_torch.sim.convert import load_encoder_pickle, save_model_pickle

    model, args, launches, _ = train_vit(torch, rc, ac, card, TRAIN_ARGS, TRAIN_STEPS,
                                         {"attention_fwd": 4, "attention_bwd": 4})

    # the checkpoint, written and read back through the loader the nav task uses
    env_args = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
                "lee_velocity_control")
    import aerial_gym_simulator_tpu_torch as port
    env = port.SimBuilder().build_env(*env_args, num_envs=TRAIN_BATCH, seed=123)
    state, batch, _ = train_vae.sample_batch(env.params, env.state, (135, 240))
    # K1 on the state sample_batch just rendered: the kernel bit-equal to its
    # plain version, broad phase on and off
    cam = env.params.camera
    k1_args = cast_inputs(env.params, state, cam, state.cam_mount_pos, state.cam_mount_quat)
    k1_err = exact_check(torch, rc, k1_args, env.params.scene.n_tri,
                         f"train ({TRAIN_BATCH}x{cam.height}x{cam.width} rays on sample_batch's "
                         f"teleported poses)", "raycast_depth")[0]
    del k1_args
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "depth_vit.pkl")
        save_model_pickle(model, path)
        size_mb = os.path.getsize(path) / 1e6
        arch, encoder = load_encoder_pickle(path)
    served = ViTImageEncoder(latent_dim=64, image_res=(135, 240), encoder=encoder,
                             compute_dtype=torch.float32, patch=encoder.patch)
    with torch.no_grad():
        mean_model, _ = model.encode(batch)
    err = (served.encode(batch[..., 0]) - mean_model).abs().max().item()
    log(f"train: checkpoint {size_mb:.1f} MB read back as {arch!r}, attn_impl "
        f"{encoder.blocks[0].attn.impl!r}; its latents equal the trained model's means to "
        f"{err:.3g}")
    if arch != "vit" or encoder.blocks[0].attn.impl != "fused" or not err <= 1e-5:
        raise AssertionError(f"train_vae checkpoint round trip: {arch}, err {err}")

    step_split(torch, model, args, env, state, card, "")
    del model, env, served, encoder
    torch.cuda.empty_cache()

    # a few steps of the conv VAE: no attention kernel
    conv_args = train_vae.build_parser().parse_args(
        ["--arch", "conv", "--batch", str(TRAIN_BATCH), "--steps", str(TRAIN_CONV_STEPS),
         "--log_every", "1"])
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    conv_model, conv_hist = train_vae.train(conv_args)
    torch.cuda.synchronize()
    conv_launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    conv_ms = (conv_hist[-1]["wall_s"] - conv_hist[1]["wall_s"]) / (TRAIN_CONV_STEPS - 2) * 1e3
    log(f"train: --arch conv {TRAIN_CONV_STEPS} steps, loss {conv_hist[0]['loss']:.5f} -> "
        f"{conv_hist[-1]['loss']:.5f}, {conv_ms:.2f} ms/step, launches {conv_launches} | {card}")
    want = {"raycast_depth": TRAIN_CONV_STEPS, "raycast_seg": 0, "raycast_normals": 0,
            "raycast_rgb": 0, **attention_counts(ac)}
    if conv_launches != want or not all(math.isfinite(h["loss"]) for h in conv_hist):
        raise AssertionError(f"conv train: launches {conv_launches}, history {conv_hist}")
    del conv_model
    torch.cuda.empty_cache()
    return launches


def train_one_head_phase(torch, rc, ac, card, argv, steps, tag, plain_tol=None):
    """train_vae with one head: at the shipped width (head_dim 256, the
    one-pass wide kernels) or the large ViT's (head_dim 512, the cluster
    kernels), each family's forward and backward once per block and step,
    counted apart from the other families (none of which may launch); the
    step's split and peak memory. With ``plain_tol``, the same steps again
    with the plain attention (``--vit_attn xla``: the same seeded model,
    batches and noise, no attention kernel), each step's loss within
    plain_tol of the kernels' run. Returns the launch counts."""
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.models import train_vae

    args = train_vae.build_parser().parse_args(argv)
    family = ac.kernel_family(args.vit_dim // args.vit_heads)
    model, args, launches, fused = train_vit(torch, rc, ac, card, argv, steps,
                                             {f"attention_fwd{family}": args.vit_depth,
                                              f"attention_bwd{family}": args.vit_depth})
    if model.encoder.blocks[0].attn.num_heads != 1:
        raise AssertionError("the one-head run did not build a one-head ViT")
    if plain_tol is not None:
        zero_counts(ac.LAUNCHES)
        plain_args = train_vae.build_parser().parse_args(
            argv + ["--steps", str(steps), "--vit_attn", "xla"])
        plain = [h["loss"] for h in train_vae.train(plain_args)[1]]
        torch.cuda.synchronize()
        diff = max(abs(a - b) for a, b in zip(fused, plain))
        third = steps // 3
        mean = lambda xs: sum(xs) / len(xs)
        log(f"train{tag}: the same {steps} steps with the plain attention (--vit_attn xla): "
            f"every step's loss within {diff:.3g} of the kernels' run (bar {plain_tol}); mean "
            f"loss over steps 0-{third - 1} / {third}-{2 * third - 1} / {2 * third}-{steps - 1}: "
            f"kernels {mean(fused[:third]):.5f} / {mean(fused[third:2 * third]):.5f} / "
            f"{mean(fused[2 * third:]):.5f}, plain {mean(plain[:third]):.5f} / "
            f"{mean(plain[third:2 * third]):.5f} / {mean(plain[2 * third:]):.5f}; attention "
            f"launches in the plain run {sum(ac.LAUNCHES.values())}")
        if len(plain) != steps or any(ac.LAUNCHES.values()) or not diff <= plain_tol:
            raise AssertionError(f"train{tag}: the plain-attention run's losses differ by {diff} "
                                 f"(launches {ac.LAUNCHES})")
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=TRAIN_BATCH, seed=123)
    state, _, _ = train_vae.sample_batch(env.params, env.state, (args.image_h, args.image_w))
    step_split(torch, model, args, env, state, card, tag)
    del model, env
    torch.cuda.empty_cache()
    return launches


def ppo_phase(torch, port, card):
    """Position PPO at the shipped width, the state-step rate, and the
    shipped position policy."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz

    cfg = PPOConfig()
    task = port.task_registry.make_task("position_setpoint_task", num_envs=cfg.num_envs, seed=0)
    trainer = PPOTrainer(task, cfg)
    flat = lambda: torch.cat([p.detach().reshape(-1) for p in trainer.network.parameters()])
    before = flat()
    steps_per_iter = cfg.num_envs * cfg.horizon
    torch.cuda.reset_peak_memory_stats()
    history = trainer.train(total_env_steps=PPO_ITERATIONS * steps_per_iter, log_every=1)
    torch.cuda.synchronize()
    if len(history) != PPO_ITERATIONS:
        raise AssertionError(f"PPO ran {len(history)} iterations")
    for m in history:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"PPO: non-finite metric in {m}")
        if not cfg.min_lr <= m["lr"] <= cfg.max_lr:
            raise AssertionError(f"PPO: lr {m['lr']} outside [{cfg.min_lr}, {cfg.max_lr}]")
    moved = (flat() - before).abs().max().item()
    if not moved > 0.0:
        raise AssertionError("PPO: the parameters did not change")
    rates = [m["env_steps_per_s"] for m in history]
    log(f"ppo: position PPO {cfg.num_envs} envs x {cfg.horizon} steps, minibatch "
        f"{cfg.minibatch_size}, {cfg.epochs} epochs: {PPO_ITERATIONS} iterations, env-steps/s "
        + ", ".join(f"{r:.1f}" for r in rates)
        + f" ({history[-1]['wall_s'] / PPO_ITERATIONS:.3f} s/iteration) | {card}")
    log("ppo: reward_mean " + ", ".join(f"{m['reward_mean']:.3f}" for m in history)
        + ", lr " + ", ".join(f"{m['lr']:.3g}" for m in history)
        + f", approx_kl {history[-1]['approx_kl']:.4f}, crash_rate {history[-1]['crash_rate']:.4f}, "
        f"largest parameter change {moved:.3g}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    rollout, t_roll = timed(torch, trainer.collect_rollout)
    _, t_upd = timed(torch, lambda: trainer.update(rollout))
    n_mb = cfg.epochs * trainer.n_minibatches
    log(f"ppo: split of a fourth iteration: rollout {t_roll:.1f} ms ({t_roll / cfg.horizon:.2f} "
        f"ms per env step), update {t_upd:.1f} ms ({n_mb} minibatch steps, "
        f"{t_upd / n_mb:.2f} ms each) | {card}")
    task.close()
    del trainer, rollout, task
    torch.cuda.empty_cache()

    # the state-step line: zero actions through make_step_fn
    task = port.task_registry.make_task("position_setpoint_task", num_envs=STATE_STEP_ENVS,
                                        seed=0)
    step_fn, carry, _ = task.make_step_fn()
    actions = torch.zeros((STATE_STEP_ENVS, 4), device=task.device)
    total = torch.zeros((), device=task.device)
    for _ in range(5):
        carry, obs, reward, term, trunc = step_fn(carry, actions)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STATE_STEPS):
        carry, obs, reward, term, trunc = step_fn(carry, actions)
        total += reward.sum()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not (torch.isfinite(total) and torch.isfinite(obs).all()):
        raise AssertionError("state step: non-finite reward or observation")
    log(f"ppo: state step, position_setpoint_task {STATE_STEP_ENVS} envs, "
        f"lee_attitude_control, zero actions: {STATE_STEPS * STATE_STEP_ENVS / dt:.1f} "
        f"env-steps/s ({dt / STATE_STEPS * 1e3:.2f} ms/step) | {card}")
    task.close()

    # the shipped position policy, closed loop
    n = 16
    task = port.task_registry.make_task("position_setpoint_task", num_envs=n, seed=321)
    policy = load_policy_npz(str(POSITION_POLICY))
    obs, *_ = task.reset()
    crashes = torch.zeros((), device=task.device)
    dist = torch.zeros((), device=task.device)
    for i in range(250):
        obs, reward, term, trunc, _ = task.step(policy(obs["observations"]))
        crashes += term.sum()
        if i >= 150:
            dist += task.state.pos.norm(dim=-1).mean() / 100.0
    crashes, dist = float(crashes), float(dist)
    log(f"ppo: shipped position policy, {n} envs, 250 steps: crashes {crashes:.0f}, mean "
        f"distance over the last 100 steps {dist:.4f} m")
    if crashes != 0 or not dist < 0.5:
        raise AssertionError(f"position policy replay: {crashes} crashes, distance {dist}")
    task.close()


def modalities_phase(torch, port, rc, card):
    """The obstacle env at full width with the normal/face-id camera through
    the user entry points: env.step + render_normal_faceid_camera (K3), then
    env.step + render("rgb") (K2 + K4). Returns the kernels' launch counts
    from these loops and the kernel's inputs on the final state."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        cast_inputs, render_normal_faceid_camera)
    t0 = time.perf_counter()
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_faceid_normal_camera",
                                      "lee_velocity_control", num_envs=NUM_ENVS, seed=0)
    torch.cuda.synchronize()
    sp = env.params.camera
    log(f"modalities: build_env({NUM_ENVS} envs, normal/face-id camera {sp.height}x{sp.width}) "
        f"{time.perf_counter() - t0:.2f} s")
    zeros = torch.zeros((NUM_ENVS, 4), device="cuda")
    env.step(zeros)                                              # warm-up
    out = render_normal_faceid_camera(env.params, env.state)
    del out
    env.render("rgb")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    t0 = time.perf_counter()
    for _ in range(MODALITY_STEPS):
        env.step(zeros)
        depth, normals, face, seg = render_normal_faceid_camera(env.params, env.state)
        finite &= torch.isfinite(depth).all() & torch.isfinite(normals).all()
        del depth, normals, face, seg                # 12.7 GB of images per capture
    torch.cuda.synchronize()
    dt_normals = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(MODALITY_STEPS):
        env.step(zeros)
        env.render("rgb")
        finite &= torch.isfinite(env.get_obs()["rgb_pixels"]).all()
    torch.cuda.synchronize()
    dt_rgb = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    obs = env.get_obs()
    rgb = obs["rgb_pixels"]
    log(f"modalities: step+render_normal_faceid_camera {MODALITY_STEPS * NUM_ENVS / dt_normals:.1f} "
        f"env-steps/s ({dt_normals / MODALITY_STEPS * 1e3:.2f} ms/step), step+render('rgb') "
        f"{MODALITY_STEPS * NUM_ENVS / dt_rgb:.1f} env-steps/s ({dt_rgb / MODALITY_STEPS * 1e3:.2f} "
        f"ms/step) | {card}")
    log(f"modalities: launches {launches}, rgb_pixels {tuple(rgb.shape)} in "
        f"[{rgb.min().item():.4f}, {rgb.max().item():.4f}], finite {bool(finite)}, peak memory "
        f"{peak_gb:.2f} GB")
    if not (bool(finite) and rgb.shape == (NUM_ENVS, sp.height, sp.width, 3)
            and rgb.min().item() >= 0.0 and rgb.max().item() <= 1.0
            and torch.isfinite(obs["depth_range_pixels"]).all()):
        raise AssertionError("bad output in the modalities loops")
    want = {"raycast_depth": 0, "raycast_seg": MODALITY_STEPS, "raycast_normals": MODALITY_STEPS,
            "raycast_rgb": MODALITY_STEPS}
    if launches != want:
        raise AssertionError(f"modalities launches {launches}, expected {want}")
    del obs, rgb
    # where a step's time goes: its pieces timed apart
    parts = {"env.step": lambda: env.step(zeros),
             "render_normal_faceid_camera": lambda: render_normal_faceid_camera(env.params,
                                                                                env.state),
             "render('rgb')": lambda: env.render("rgb")}
    split = {name: wall_ms(torch, fn) for name, fn in parts.items()}
    log("modalities: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" (render('rgb') = K4 + the camera's K2 render) | {card}")
    args = cast_inputs(env.params, env.state, sp, env.state.cam_mount_pos,
                       env.state.cam_mount_quat)
    n_tri = env.params.scene.n_tri
    del env, parts
    torch.cuda.empty_cache()
    return launches, args, n_tri


def ppo_iterations(torch, trainer, iterations, tag, card):
    """``iterations`` PPO iterations through PPOTrainer.train: finite
    metrics, the parameters moved, the lr inside its bounds. Logs seconds
    and env-steps/s per iteration and the reward; returns the history."""
    cfg = trainer.cfg
    flat = lambda: torch.cat([p.detach().reshape(-1) for p in trainer.network.parameters()])
    before = flat()
    steps_per_iter = cfg.num_envs * cfg.horizon
    history = trainer.train(total_env_steps=iterations * steps_per_iter, log_every=1)
    torch.cuda.synchronize()
    if len(history) != iterations:
        raise AssertionError(f"{tag}: PPO ran {len(history)} iterations")
    for m in history:
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"{tag}: non-finite metric in {m}")
        if not cfg.min_lr <= m["lr"] <= cfg.max_lr:
            raise AssertionError(f"{tag}: lr {m['lr']} outside [{cfg.min_lr}, {cfg.max_lr}]")
    moved = (flat() - before).abs().max().item()
    if not moved > 0.0:
        raise AssertionError(f"{tag}: the parameters did not change")
    walls = [m["wall_s"] for m in history]
    seconds = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
    log(f"{tag}: {iterations} iterations of {cfg.num_envs} envs x {cfg.horizon} steps, "
        f"minibatch {trainer.mb_size}, {cfg.epochs} epochs: s/iteration "
        + ", ".join(f"{x:.3f}" for x in seconds) + ", env-steps/s "
        + ", ".join(f"{m['env_steps_per_s']:.1f}" for m in history) + f" | {card}")
    log(f"{tag}: reward_mean " + ", ".join(f"{m['reward_mean']:.3f}" for m in history)
        + ", pg_loss " + ", ".join(f"{m['pg_loss']:.4f}" for m in history)
        + ", v_loss " + ", ".join(f"{m['v_loss']:.4f}" for m in history)
        + f", lr {history[-1]['lr']:.3g}, largest parameter change {moved:.3g}")
    return history


def training_snapshot(torch, trainer):
    """Clones of everything training evolves: the parameters, Adam's state,
    the normalizer, the lr, the observation, the trainer's and the carry's
    generator states and the carry's poses."""
    carry = trainer.env_carry[0] if trainer.cfg.rnn else trainer.env_carry
    sim = getattr(carry, "sim", carry)
    out = {f"param.{k}": v for k, v in trainer.network.state_dict().items()}
    for i, prm in enumerate(trainer.network.parameters()):
        out.update({f"adam.{i}.{k}": v for k, v in trainer.optimizer.state[prm].items()})
    out.update({f"norm.{k}": v for k, v in trainer.norm.items()})
    out.update(lr=trainer.lr, obs=trainer.obs, pos=sim.pos,
               generator=trainer.generator.get_state(), sim_rng=carry.rng.get_state())
    return {k: v.detach().clone() for k, v in out.items()}


def navppo_phase(torch, port, rc, ac, card):
    """Navigation PPO: the rl.ppo command line's trainer (build_trainer) on
    navigation_task at NAV_ENVS envs with the shipped ViT encoder (bf16,
    K5), NAVPPO_ITERATIONS iterations at the JAX recipe's settings
    (scripts/revalidate_nav_e2e.sh: horizon 32, minibatch 8192). K1 once
    and K5 four times per env step; then the split of one more iteration
    and the encoder against its plain version on the final depth images.
    Returns the launch counts of the training run, the checks, and a
    snapshot of the trained state (the straight run the plumbing phase
    resumes to)."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import build_trainer, parse_args
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import render_camera
    task, trainer = build_trainer(parse_args(NAVPPO_ARGS))
    ppo_cfg = trainer.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    ppo_iterations(torch, trainer, NAVPPO_ITERATIONS, "navppo", card)
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    steps = NAVPPO_ITERATIONS * ppo_cfg.horizon
    want = {"raycast_depth": steps, "raycast_seg": 0, "raycast_normals": 0, "raycast_rgb": 0,
            **attention_counts(ac, attention_fwd=4 * steps)}
    log(f"navppo: launches {launches} ({steps} env steps), curriculum level "
        f"{float(task.nav_state.curriculum_level):.0f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if launches != want:
        raise AssertionError(f"navppo launches {launches}, expected {want}")
    if task.nav_state is not trainer.env_carry:
        raise AssertionError("navppo: set_carry did not hand the carry back to the task")
    straight = training_snapshot(torch, trainer)
    rollout, t_roll = timed(torch, trainer.collect_rollout)
    _, t_upd = timed(torch, lambda: trainer.update(rollout))
    n_mb = ppo_cfg.epochs * trainer.n_minibatches
    log(f"navppo: split of a fifth iteration: rollout {t_roll:.1f} ms ({t_roll / ppo_cfg.horizon:.2f} "
        f"ms per env step), update {t_upd:.1f} ms ({n_mb} minibatch steps, {t_upd / n_mb:.2f} "
        f"ms each) | {card}")
    # the rollout's env step (the policy's share is under 1%) and an update
    action = torch.zeros((NAV_ENVS, 4), device=task.device)
    busy = {"task.step": device_busy(torch, lambda: task.step(action), 3),
            "update": device_busy(torch, lambda: trainer.update(rollout), 1)}
    log("navppo: under the profiler: " + "; ".join(
        f"{k} {busy_text(*v)}" for k, v in busy.items()) + f" | {card}")
    pixels, _ = render_camera(task.params, trainer.env_carry.sim, want_seg=False)
    err = encoder_against_plain(torch, ac, task.vae, pixels)
    task.close()
    del trainer, rollout, task, pixels
    torch.cuda.empty_cache()
    return launches, {"latent_err_vs_reference": err,
                      "device_idle_share": {k: 1.0 - b / w for k, (w, b) in busy.items()}}, straight


def nav_split(torch, task, policy, parts, tag, card):
    """Each piece of the step timed apart on the final state."""
    split = {name: wall_ms(torch, fn, 5) for name, fn in parts.items()}
    log(f"{tag}: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" | {card}")
    return split


def pointcloud_nav_phase(torch, port, rc, card, task_name, policy_file, steps, tag):
    """A pointcloud navigation task at LIDARNAV_ENVS envs flown by a shipped
    policy through the port's loader (per-env hidden resets for a recurrent
    one): finite actions, at least one success, K1 once per step on the
    48x120 table; the step's split (env_step, render, pointcloud
    processing, policy); then K1 on this scene and ray table held bit-equal
    to its plain version, timed, and its bound. Returns (task, launches,
    the K1 record)."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs, render_lidar
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
    from aerial_gym_simulator_tpu_torch.tasks import lidar_navigation_task as lid
    t0 = time.perf_counter()
    task = port.task_registry.make_task(task_name, num_envs=LIDARNAV_ENVS, seed=99)
    policy = load_policy_npz(str(policy_file), num_envs=LIDARNAV_ENVS)
    recurrent = getattr(policy, "recurrent", False)
    params, cfg = task.params, task.task_config
    sp = params.lidar
    torch.cuda.synchronize()
    log(f"{tag}: make_task({LIDARNAV_ENVS} envs, {cfg.robot_name}, {cfg.controller_name}, "
        f"{cfg.env_name}: {params.scene.num_assets} obstacle slots, curriculum from "
        f"{cfg.curriculum.min_level}) {time.perf_counter() - t0:.2f} s; "
        f"{'recurrent' if recurrent else 'MLP'} policy {policy_file.name}")
    fly(torch, task, policy, 3, recurrent)                          # warm-up
    if recurrent:
        policy.reset()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES)
    dt, (succ, crash, timo) = fly(torch, task, policy, steps, recurrent)
    launches = dict(rc.LAUNCHES)
    ended = succ + crash + timo
    share = succ / max(ended, 1.0)
    log(f"{tag}: {steps} steps {steps * LIDARNAV_ENVS / dt:.1f} env-steps/s "
        f"({dt / steps * 1e3:.2f} ms/step) | {card}")
    log(f"{tag}: launches {launches}, successes {succ:.0f} crashes {crash:.0f} timeouts "
        f"{timo:.0f} (success share {share:.3f}), curriculum level "
        f"{float(task.nav_state.curriculum_level):.0f}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    want = {"raycast_depth": steps, "raycast_seg": 0, "raycast_normals": 0, "raycast_rgb": 0}
    if launches != want:
        raise AssertionError(f"{tag} launches {launches}, expected {want}")
    if not succ > 0:
        raise AssertionError(f"{tag}: no success in {steps} steps ({succ}/{crash}/{timo})")

    ns = task.nav_state
    obs = task.task_obs["observations"]
    action = lid.action_transform(cfg, policy(obs))
    pts, _ = render_lidar(params, ns.sim, want_seg=False)
    draws = lid.sample_lidar_nav_draws(ns.rng, LIDARNAV_ENVS, task.device)
    none_done = torch.zeros(LIDARNAV_ENVS, device=task.device)
    split = nav_split(torch, task, policy, {
        "env_step": lambda: dynamics.env_step(params, ns.sim, action),
        "reset_envs": lambda: dynamics.reset_envs(params, ns.sim, none_done),
        "render": lambda: render_lidar(params, ns.sim, want_seg=False),
        "pointcloud": lambda: lid.process_pointcloud(cfg, ns.sim.pos, ns.sim.linvel, pts,
                                                     draws),
        "policy": lambda: policy(obs),
        "task.step": lambda: task.step(action),
    }, tag, card)
    wall, busy = device_busy(torch, lambda: task.step(action), 3)
    log(f"{tag}: task.step under the profiler: {busy_text(wall, busy)} | {card}")
    st = task.nav_state.sim
    args = cast_inputs(params, st, sp, st.lidar_mount_pos, st.lidar_mount_quat)
    rec, _ = time_mode(torch, rc, args, params.scene.n_tri, "raycast_depth", card, tag)
    rec.update(launches=launches["raycast_depth"], library_ms=None, success_share=share,
               outcomes=[succ, crash, timo], env_steps_per_s=steps * LIDARNAV_ENVS / dt,
               split_ms=split, device_idle_share_of_task_step=1.0 - busy / wall)
    return task, launches, rec


def radar_ppo_phase(torch, task, rc, card):
    """Recurrent PPO on the radar task (the recipe of
    scripts/train_radar_e2e.sh: GRU of 128, entropy 0.001, horizon 32,
    minibatch 8192 = 256 env sequences): RADAR_PPO_ITERATIONS iterations,
    finite losses, the policy moved, K1 once per env step. Returns the
    launches."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    cfg = PPOConfig(num_envs=LIDARNAV_ENVS, minibatch_size=min(8192, LIDARNAV_ENVS * 32),
                    entropy_coef=0.001, rnn="gru", rnn_hidden=RADAR_RNN_HIDDEN, seed=7)
    trainer = PPOTrainer(task, cfg)
    zero_counts(rc.LAUNCHES)
    ppo_iterations(torch, trainer, RADAR_PPO_ITERATIONS, "radarnav ppo", card)
    launches = dict(rc.LAUNCHES)
    steps = RADAR_PPO_ITERATIONS * cfg.horizon
    if launches["raycast_depth"] != steps or task.nav_state is not trainer.env_carry[0]:
        raise AssertionError(f"radarnav ppo: launches {launches} for {steps} env steps, or the "
                             "task did not get its carry back")
    log(f"radarnav ppo: launches {launches}, {trainer.n_minibatches} minibatches of "
        f"{trainer.mb_envs} env sequences an epoch")
    return launches


def lidar_phase(torch, port, rc, card):
    """The obstacle env with the 128x512 lidar through the user entry points:
    env.step + render() (K2) + render_normal_faceid_lidar (K3). Returns the
    kernels' launch counts and the kernel's inputs on the final state."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        cast_inputs, render_normal_faceid_lidar)
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_lidar", "lee_velocity_control",
                                      num_envs=LIDAR_ENVS, seed=0)
    sp = env.params.lidar
    zeros = torch.zeros((LIDAR_ENVS, 4), device="cuda")
    env.step(zeros)                                              # warm-up
    env.render()
    out = render_normal_faceid_lidar(env.params, env.state)
    del out
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    t0 = time.perf_counter()
    for _ in range(LIDAR_STEPS):
        env.step(zeros)
        env.render()
        depth, normals, face, seg = render_normal_faceid_lidar(env.params, env.state)
        finite &= (torch.isfinite(env.get_obs()["depth_range_pixels"]).all()
                   & torch.isfinite(depth).all() & torch.isfinite(normals).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    obs = env.get_obs()
    hit_share = (face >= 0).float().mean().item()
    log(f"lidar: {LIDAR_ENVS} envs, {sp.height}x{sp.width} lidar: step+render()+"
        f"render_normal_faceid_lidar {LIDAR_STEPS * LIDAR_ENVS / dt:.1f} env-steps/s "
        f"({dt / LIDAR_STEPS * 1e3:.2f} ms/step) | {card}")
    log(f"lidar: launches {launches}, depth_range_pixels {tuple(obs['depth_range_pixels'].shape)}, "
        f"hit share {hit_share:.4f}, finite {bool(finite)}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not (bool(finite) and obs["depth_range_pixels"].shape == (LIDAR_ENVS, sp.height, sp.width)
            and obs["segmentation_pixels"].shape == (LIDAR_ENVS, sp.height, sp.width)
            and normals.shape == (LIDAR_ENVS, sp.height, sp.width, 3)):
        raise AssertionError("bad output in the lidar loop")
    want = {"raycast_depth": 0, "raycast_seg": LIDAR_STEPS, "raycast_normals": LIDAR_STEPS,
            "raycast_rgb": 0}
    if launches != want:
        raise AssertionError(f"lidar launches {launches}, expected {want}")
    args = cast_inputs(env.params, env.state, sp, env.state.lidar_mount_pos,
                       env.state.lidar_mount_quat)
    n_tri = env.params.scene.n_tri
    del env, obs, depth, normals, face, seg
    torch.cuda.empty_cache()
    return launches, args, n_tri


def collision_phase(torch, port, rc, ac, card):
    """train_vae --collision_targets at the JAX CLI's defaults (conv VAE,
    batch 64, 135x240, Adam 1e-4) for COLLISION_STEPS steps: finite losses,
    K1 (the noisy raw render) and K2 (the inflated scene's render) once per
    step each and nothing else; ms per step and its split; K2 on the
    inflated table bit-equal to its plain version, timed with its bound.
    Returns (launches, K2's timing record on the inflated table)."""
    from aerial_gym_simulator_tpu_torch.models import train_vae
    from aerial_gym_simulator_tpu_torch.models.vae import vae_loss
    from aerial_gym_simulator_tpu_torch.utils.collision_image_generator import (
        inflated_cast_inputs, render_inflated_depth)

    args = train_vae.build_parser().parse_args(COLLISION_ARGS
                                               + ["--steps", str(COLLISION_STEPS)])
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    t0 = time.perf_counter()
    model, history = train_vae.train(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    losses = [h["loss"] for h in history]
    steady = (history[-1]["wall_s"] - history[4]["wall_s"]) / (COLLISION_STEPS - 5) * 1e3
    log(f"collision: train_vae --arch conv --collision_targets, batch {args.batch}, "
        f"{args.image_h}x{args.image_w}, lr {args.lr}: {COLLISION_STEPS} steps in {wall:.2f} s "
        f"incl. set-up, {steady:.2f} ms/step after the first 5 | {card}")
    log(f"collision: loss {losses[0]:.5f} -> {losses[-1]:.5f} (bce {history[-1]['bce']:.5f}, "
        f"kld {history[-1]['kld']:.4f}), launches {launches}, peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    if not all(math.isfinite(h[k]) for h in history for k in ("loss", "bce", "kld")):
        raise AssertionError(f"collision: non-finite loss in {losses}")
    want = {"raycast_depth": COLLISION_STEPS, "raycast_seg": COLLISION_STEPS,
            "raycast_normals": 0, "raycast_rgb": 0, **attention_counts(ac)}
    if launches != want:
        raise AssertionError(f"collision launches {launches}, expected {want}")

    # the split of a step on fresh batches
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=args.batch, seed=123)
    params, state = env.params, env.state
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    gen = torch.Generator(device=env.device).manual_seed(1)
    hw = (args.image_h, args.image_w)
    split = {"sample+render": 0.0, "inflated render": 0.0, "forward": 0.0, "backward": 0.0,
             "Adam": 0.0}
    reps = 5
    for rep in range(reps + 1):
        with torch.no_grad():
            (state, batch, targets), t_all = timed(
                torch, lambda: train_vae.sample_batch(params, state, hw, True))
            _, t_infl = timed(torch, lambda: render_inflated_depth(params, state))
        optimizer.zero_grad(set_to_none=True)
        (loss, _), t_f = timed(torch, lambda: vae_loss(model, batch, generator=gen,
                                                        targets=targets))
        _, t_b = timed(torch, loss.backward)
        _, t_o = timed(torch, optimizer.step)
        if rep:                                            # the first pass warms up
            for name, t in zip(split, (t_all - t_infl, t_infl, t_f, t_b, t_o)):
                split[name] += t / reps
    log("collision: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" = {sum(split.values()):.2f} ms/step (the inflated render timed alone on the "
        f"batch's state, the rest of sample_batch the remainder) | {card}")
    if not (targets.min() >= 0.0 and targets.max() <= 1.0 and not torch.equal(targets, batch)):
        raise AssertionError("collision: targets outside [0, 1] or equal to the inputs")

    # K2 on the inflated table of the last batch's state, as render_inflated_depth packs it
    radius = float(params.robot.collision_radius)
    k2_args, n_tri = inflated_cast_inputs(params, state, radius)
    tag = f"collision (inflated by {radius:.4f} m)"
    rec, _ = time_mode(torch, rc, k2_args, n_tri, "raycast_seg", card, tag)
    del model, env, optimizer, k2_args
    torch.cuda.empty_cache()
    return launches, dict(rec, launches=launches["raycast_seg"], library_ms=None,
                          inflation_radius_m=radius)


def variants_phase(torch, port, rc, ac, card):
    """The position-task variants through task_registry.make_task at their
    configs' envs, VARIANT_STEPS steps each from seeded actions; PPO on the
    end-to-end task; the 8-motor robots stepped through SimBuilder; the
    device's idle share of a variant step and a robot step. No kernel runs
    on these paths: every launch count stays 0."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    busy = {}
    for name, obs_dim in VARIANT_TASKS.items():
        task = port.task_registry.make_task(name)
        n = task.num_envs
        gen = torch.Generator(device=task.device).manual_seed(0)
        actions = torch.rand((VARIANT_STEPS, n, 4), generator=gen, device=task.device) * 2 - 1
        obs, *_ = task.reset()
        totals = torch.zeros(3, device=task.device)
        finite = torch.ones((), dtype=torch.bool, device=task.device)
        task.step(actions[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in actions:
            obs, rew, term, trunc, _ = task.step(a)
            totals += torch.stack([rew.mean(), term.sum(), trunc.sum()])
            finite &= torch.isfinite(obs["observations"]).all() & torch.isfinite(rew).all()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        reward_mean, crashes, truncations = (float(x) for x in totals)
        cfg = task.task_config
        log(f"variants: {name} ({cfg.robot_name}, {cfg.controller_name}) {n} envs, "
            f"{VARIANT_STEPS} steps: {VARIANT_STEPS * n / dt:.1f} env-steps/s "
            f"({dt / VARIANT_STEPS * 1e3:.2f} ms/step), reward mean "
            f"{reward_mean / VARIANT_STEPS:.4f}, crashes {crashes:.0f}, truncations "
            f"{truncations:.0f} | {card}")
        shape = tuple(obs["observations"].shape)
        if not bool(finite) or shape != (n, obs_dim) or tuple(rew.shape) != (n,):
            raise AssertionError(f"variants: {name}: finite {bool(finite)}, obs {shape}")
        if task.params.controller.num_actions != 4:
            raise AssertionError(f"variants: {name} takes "
                                 f"{task.params.controller.num_actions} actions")
        if name == VARIANT_PPO_TASK:
            busy[name] = device_busy(torch, lambda: task.step(actions[0]), 10)
        task.close()
        del task, actions

    # PPO on the end-to-end task at PPOConfig's other defaults
    task = port.task_registry.make_task(VARIANT_PPO_TASK, num_envs=VARIANT_PPO_ENVS)
    ppo_cfg = PPOConfig(num_envs=VARIANT_PPO_ENVS)
    trainer = PPOTrainer(task, ppo_cfg)
    torch.cuda.reset_peak_memory_stats()
    ppo_iterations(torch, trainer, VARIANT_PPO_ITERATIONS, "variants ppo", card)
    if task._carry is not trainer.env_carry:
        raise AssertionError("variants ppo: set_carry did not hand the carry back to the task")
    rollout, t_roll = timed(torch, trainer.collect_rollout)
    _, t_upd = timed(torch, lambda: trainer.update(rollout))
    n_mb = ppo_cfg.epochs * trainer.n_minibatches
    log(f"variants ppo: split of a fourth iteration: rollout {t_roll:.1f} ms "
        f"({t_roll / ppo_cfg.horizon:.2f} ms per env step), update {t_upd:.1f} ms ({n_mb} "
        f"minibatch steps, {t_upd / n_mb:.2f} ms each), peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB | {card}")
    task.close()
    del trainer, rollout, task
    torch.cuda.empty_cache()

    # the 8-motor robots: reversible thrust, full-rank allocation
    for robot, controller in ROBOT_PAIRS:
        env = port.SimBuilder().build_env("base_sim", "empty_env", robot, controller,
                                          num_envs=ROBOT_ENVS, seed=0)
        env.reset()
        A = env.params.controller.num_actions
        gen = torch.Generator(device=env.device).manual_seed(1)
        a = torch.rand((ROBOT_ENVS, A), generator=gen, device=env.device) - 0.5
        if A == 7:                                   # position + a near-level attitude
            a[:, 3:7] = 0.1 * a[:, 3:7] + torch.tensor([0.0, 0.0, 0.0, 1.0], device=env.device)
        env.step(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(ROBOT_STEPS):
            env.step(a)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        st = env.state
        finite = bool(torch.isfinite(st.pos).all() and torch.isfinite(st.quat).all())
        log(f"variants: {robot} + {controller}, {ROBOT_ENVS} envs, {ROBOT_STEPS} steps: "
            f"{ROBOT_STEPS * ROBOT_ENVS / dt:.1f} env-steps/s ({dt / ROBOT_STEPS * 1e3:.2f} "
            f"ms/step), motor thrust in [{float(st.motor_thrust.min()):.3f}, "
            f"{float(st.motor_thrust.max()):.3f}] N, crashes {int(st.crashes.sum())}, finite "
            f"poses {finite} | {card}")
        if not finite:
            raise AssertionError(f"variants: {robot}: non-finite pose")
        if robot == "base_octarotor":
            busy[f"{robot} env.step"] = device_busy(torch, lambda: env.step(a), 10)
        env.delete_env()
        del env
    log("variants: under the profiler: " + "; ".join(
        f"{k} {busy_text(*v)}" for k, v in busy.items()) + f" | {card}")
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"variants: a kernel launched on a state-only path: {launches}")


JAX_HISTORY_KEYS = {"reward_mean", "done_rate", "crash_rate", "pg_loss", "v_loss", "entropy",
                    "approx_kl", "lr", "value_mean", "iter", "env_steps", "wall_s",
                    "env_steps_per_s_cumulative", "env_steps_per_s"}


def cli_subphase(torch, work, card):
    """12a. ``python -m aerial_gym_simulator_tpu_torch.rl.ppo`` as a user
    runs it: position PPO at ppo_aerial_quad.yaml's width, 3 iterations,
    with --logdir and --save; rc 0, the final line, metrics.jsonl, and the
    saved policy exported and flown on the card. No kernel on this path."""
    from aerial_gym_simulator_tpu_torch.sim2real.policy import (export_policy_npz,
                                                                load_policy_npz)
    logdir, save = os.path.join(work, "cli_logs"), os.path.join(work, "cli_policy.ckpt")
    root = str(Path(__file__).resolve().parent)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [root] + [x for x in os.environ.get("PYTHONPATH", "").split(os.pathsep) if x]))
    cmd = [sys.executable, "-m", "aerial_gym_simulator_tpu_torch.rl.ppo", *CLI_ARGS,
           "--logdir", logdir, "--save", save]
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines or not lines[-1].startswith("final reward:"):
        raise AssertionError(f"plumbing cli: rc {proc.returncode}\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        points = [json.loads(line) for line in f]
    if [m["iter"] for m in points] != [0, 2] or any(
            set(m) != JAX_HISTORY_KEYS | {"step"} for m in points):
        raise AssertionError(f"plumbing cli: metrics.jsonl {points}")
    policy = load_policy_npz(export_policy_npz(save, os.path.join(work, "cli_policy.npz")))
    dev = policy.norm_mean.device
    obs = torch.randn((8192, 13), device=dev, generator=torch.Generator(device=dev).manual_seed(1))
    if not torch.isfinite(policy(obs)).all():
        raise AssertionError("plumbing cli: the exported policy acts non-finite")
    log(f"plumbing cli: {' '.join(cmd[1:])}: rc 0, {wall:.1f} s wall, "
        f"{points[-1]['wall_s'] / 3:.3f} s/iteration in the run, env-steps/s "
        + ", ".join(f"{m['env_steps_per_s']:.1f}" for m in points)
        + f"; {lines[-1]}; metrics.jsonl {len(points)} lines; the saved policy exported and "
        f"flown on the card | {card}")
    return wall


def resume_subphase(torch, rc, ac, work, straight, card):
    """12b. Exact resume of navigation PPO at full width: a victim run of
    RESUME_AT iterations saves its training state and is thrown away, a
    fresh trainer resumes to NAVPPO_ITERATIONS; its state against the
    navppo phase's straight run, bit for bit. Returns the launches of the
    two runs."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import build_trainer, parse_args
    ckpt, spare = os.path.join(work, "nav_ckpt"), os.path.join(work, "nav_ckpt_timing")
    task, victim = build_trainer(parse_args(NAVPPO_ARGS))
    spi = victim.cfg.num_envs * victim.cfg.horizon
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    victim.train(total_env_steps=RESUME_AT * spi, log_every=1, ckpt_dir=ckpt,
                 save_every=RESUME_AT)
    torch.cuda.synchronize()
    launches = {"victim": {**rc.LAUNCHES, **ac.LAUNCHES}}
    path = os.path.join(ckpt, f"iter_{RESUME_AT}.pt")
    size_mb = os.path.getsize(path) / 1e6
    _, save_ms = timed(torch, lambda: victim.save_training_state(spare))
    _, restore_ms = timed(torch, lambda: victim.restore_training_state(ckpt))
    task.close()
    del task, victim
    torch.cuda.empty_cache()

    task, resumed = build_trainer(parse_args(NAVPPO_ARGS))
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    history = resumed.train(total_env_steps=NAVPPO_ITERATIONS * spi, log_every=1,
                            ckpt_dir=ckpt, save_every=NAVPPO_ITERATIONS, resume=True)
    torch.cuda.synchronize()
    launches["resumed"] = {**rc.LAUNCHES, **ac.LAUNCHES}
    steps = (NAVPPO_ITERATIONS - RESUME_AT) * resumed.cfg.horizon
    for run, n in (("victim", RESUME_AT * resumed.cfg.horizon), ("resumed", steps)):
        got = launches[run]
        if got["raycast_depth"] != n or got["attention_fwd"] != 4 * n:
            raise AssertionError(f"plumbing resume: {run} launches {got} for {n} env steps")
    if [m["iter"] for m in history] != list(range(RESUME_AT, NAVPPO_ITERATIONS)):
        raise AssertionError(f"plumbing resume: iterations {[m['iter'] for m in history]}")
    got = training_snapshot(torch, resumed)
    differ = {k: (straight[k].double() - got[k].double()).abs().max().item()
              for k in straight if not torch.equal(straight[k], got[k])}
    walls = [m["wall_s"] for m in history]
    log(f"plumbing resume: navigation PPO {resumed.cfg.num_envs} envs x {resumed.cfg.horizon}, "
        f"{RESUME_AT} iterations saved, resumed to {NAVPPO_ITERATIONS}: checkpoint "
        f"{size_mb:.3f} MB, save {save_ms:.1f} ms, restore {restore_ms:.1f} ms; resumed "
        f"s/iteration " + ", ".join(f"{b - a:.3f}" for a, b in zip([0.0] + walls[:-1], walls))
        + f"; launches victim {launches['victim']['raycast_depth']} K1 / "
        f"{launches['victim']['attention_fwd']} K5, resumed "
        f"{launches['resumed']['raycast_depth']} K1 / {launches['resumed']['attention_fwd']} K5 "
        f"| {card}")
    log(f"plumbing resume: against the straight run, {len(straight)} tensors (parameters, Adam "
        f"state, normalizer, lr, obs, generator states, env_carry.pos): "
        + ("all bit-equal" if not differ else f"{len(differ)} differ: {differ}"))
    if differ:
        raise AssertionError(f"plumbing resume: not bit-equal to the straight run: {differ}")
    task.close()
    del task, resumed
    torch.cuda.empty_cache()
    return launches, {"checkpoint_mb": size_mb, "save_ms": save_ms, "restore_ms": restore_ms}


def sim_state_subphase(torch, port, rc, work, card):
    """12c. Saved sim state on the card: the obstacle env with a noisy
    segmentation camera at SIM_STATE_ENVS envs, 5 steps, save_state, 3
    steps with render() (K2), load_state, the same 3 again: poses and
    frames bit-equal. Returns the K2 launches."""
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")
    env = port.SimBuilder().build_env(*names, num_envs=SIM_STATE_ENVS, seed=3)
    env.params = replace(env.params, camera=replace(env.params.camera, enable_noise=True))
    actions = torch.full((SIM_STATE_ENVS, 4), 0.1, device=env.device)
    for _ in range(5):
        env.step(actions)
    path = os.path.join(work, "sim_state.pt")
    _, save_ms = timed(torch, lambda: env.save_state(path))
    zero_counts(rc.LAUNCHES)
    runs = []
    for i in range(2):
        if i:
            _, load_ms = timed(torch, lambda: env.load_state(path))
        run = []
        for _ in range(3):
            env.step(actions)
            env.render()
            obs = env.get_obs()
            run.append((env.state.pos.clone(), obs["depth_range_pixels"].clone(),
                        obs["segmentation_pixels"].clone()))
        runs.append(run)
    torch.cuda.synchronize()
    launches = dict(rc.LAUNCHES)
    equal = all(torch.equal(a, b) for r1, r2 in zip(*runs) for a, b in zip(r1, r2))
    moved = not torch.equal(runs[0][0][1], runs[0][1][1])
    log(f"plumbing sim state: {SIM_STATE_ENVS} envs, noisy segmentation camera: "
        f"{os.path.getsize(path) / 1e6:.3f} MB, save {save_ms:.1f} ms, load {load_ms:.1f} ms; "
        f"3 steps + render() replayed: poses and frames "
        f"{'bit-equal' if equal else 'DIFFER'}; launches {launches} | {card}")
    if not (equal and moved) or launches["raycast_seg"] != 6 or launches["raycast_depth"]:
        raise AssertionError(f"plumbing sim state: equal {equal}, frames moved {moved}, "
                             f"launches {launches}")
    del env, runs
    torch.cuda.empty_cache()
    return launches


def wrappers_subphase(torch, port, rc, ac, work, card):
    """12d. AerialGymVecEnv on the navigation task (conv VAE) with CUDA
    torch actions, CustomTask at CUSTOM_ENVS envs, and the navigation task
    with a seeded reference-layout .pth VAE (models/torch_vae_import),
    whose latents on the card are held against the same module on the CPU.
    Returns the launches of the two navigation runs."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.models import torch_vae_import as tvi
    from aerial_gym_simulator_tpu_torch.rl_training.vec_env import AerialGymVecEnv
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import render_camera
    from aerial_gym_simulator_tpu_torch.tasks.custom_task import CustomTask, CustomTaskConfig
    launches = {}
    venv = AerialGymVecEnv(port.task_registry.make_task("navigation_task", num_envs=NAV_ENVS,
                                                        seed=11))
    dev = venv.task.device
    gen = torch.Generator(device=dev).manual_seed(5)
    venv.reset(seed=0)
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(10):
        obs, rew, term, trunc, _ = venv.step(torch.rand((NAV_ENVS, 4), device=dev,
                                                        generator=gen) * 2 - 1)
    dt = time.perf_counter() - t0
    launches["vec_env"] = {**rc.LAUNCHES, **ac.LAUNCHES}
    ok = (isinstance(obs["obs"], np.ndarray) and obs["obs"].shape == (NAV_ENVS, 81)
          and np.isfinite(obs["obs"]).all() and np.isfinite(rew).all()
          and term.dtype == np.bool_ and trunc.dtype == np.bool_)
    if not ok or launches["vec_env"]["raycast_depth"] != 10:
        raise AssertionError(f"plumbing vec env: outputs ok {ok}, launches {launches['vec_env']}")
    log(f"plumbing vec env: AerialGymVecEnv(navigation_task, {NAV_ENVS} envs), 10 steps of CUDA "
        f"actions: numpy obs {obs['obs'].shape} {obs['obs'].dtype}, bool dones, "
        f"{dt / 10 * 1e3:.1f} ms per step; launches {launches['vec_env']} | {card}")
    venv.close()
    del venv

    task = CustomTask(CustomTaskConfig(num_envs=CUSTOM_ENVS))
    task.reset()
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        obs, rew, *_ = task.step(torch.rand((CUSTOM_ENVS, 4), device=dev, generator=gen))
        finite &= torch.isfinite(obs["observations"]).all() & torch.isfinite(rew).all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("plumbing custom task: non-finite observation or reward")
    log(f"plumbing custom task: CustomTask {CUSTOM_ENVS} envs, 20 steps finite, "
        f"{dt / 20 * 1e3:.2f} ms per step ({20 * CUSTOM_ENVS / dt:.1f} env-steps/s) | {card}")
    task.close()
    del task

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc, dec = tvi.ImgEncoder(), tvi.ImgDecoder()
    sd = {f"encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update({f"img_decoder.{k}": v for k, v in dec.state_dict().items()})
    pth = os.path.join(work, "reference_vae.pth")
    torch.save(sd, pth)
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              torch_vae_path=pth)
    task = port.task_registry.make_task("navigation_task", num_envs=NAV_ENVS, seed=13,
                                        task_config=cfg)
    obs, *_ = task.reset()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        obs, rew, *_ = task.step(torch.rand((NAV_ENVS, 4), device=dev, generator=gen) * 2 - 1)
        finite &= torch.isfinite(obs["observations"]).all() & torch.isfinite(rew).all()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches["torch_vae"] = {**rc.LAUNCHES, **ac.LAUNCHES}
    pixels, _ = render_camera(task.params, task.nav_state.sim, want_seg=False)
    pixels = pixels[:VAE_CPU_IMAGES]
    card_mean = task.vae.encode_moments(pixels)[0]
    cpu_mean = tvi.TorchVAEImageEncoder(pth, device="cpu").encode_moments(pixels.cpu())[0]
    err = (card_mean.cpu() - cpu_mean).abs().max().item()
    log(f"plumbing torch vae: navigation_task {NAV_ENVS} envs with a seeded reference-layout "
        f".pth VAE (270x480 input), 20 steps: finite {bool(finite)}, {dt / 20 * 1e3:.1f} ms per "
        f"step, launches {launches['torch_vae']}; latents of {VAE_CPU_IMAGES} images on the card "
        f"against the CPU max abs err {err:.3g} (bar 1e-4) | {card}")
    if not bool(finite) or launches["torch_vae"]["raycast_depth"] != 20 or not err <= 1e-4:
        raise AssertionError(f"plumbing torch vae: finite {bool(finite)}, launches "
                             f"{launches['torch_vae']}, latent err {err}")
    task.close()
    del task, pixels
    torch.cuda.empty_cache()
    return launches, err


def plumbing_phase(torch, port, rc, ac, card, straight):
    """12. The training plumbing: the CLI as a process, exact resume of
    navigation PPO, saved sim state, the wrappers, the custom task and the
    reference-VAE importer. Returns the launches and the checks."""
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_plumbing_") as work:
        t0 = time.perf_counter()
        cli_subphase(torch, work, card)
        t1 = time.perf_counter()
        resume_launches, out["resume"] = resume_subphase(torch, rc, ac, work, straight, card)
        t2 = time.perf_counter()
        out["sim_state_launches"] = sim_state_subphase(torch, port, rc, work, card)
        t3 = time.perf_counter()
        wrapper_launches, out["torch_vae_latent_err_vs_cpu"] = wrappers_subphase(
            torch, port, rc, ac, work, card)
        t4 = time.perf_counter()
    log(f"plumbing: seconds a {t1 - t0:.1f}, b {t2 - t1:.1f}, c {t3 - t2:.1f}, "
        f"d {t4 - t3:.1f} (total {t4 - t0:.1f})")
    out["launches"] = {**resume_launches, "sim_state": out.pop("sim_state_launches"),
                       **wrapper_launches}
    return out


def time_mode(torch, rc, args, n_tri, name, card, tag, face=None):
    """One ray-cast mode at one path's shapes: kernel ms by CUDA events, the
    exact check against the plain version (timed once), and the bound.
    ``face`` (the normal mode's, on the same inputs) counts the RGB mode's
    per-hit work. Returns the record's numbers and the face ids of the
    normal mode."""
    ms = event_ms(torch, lambda: rc.raycast(*args, n_tri=n_tri, **MODE_KW[name]), 5)
    err, plain_ms, k = exact_check(torch, rc, args, n_tri, f"{tag} (timed)", name)
    if name == "raycast_normals":
        face = k[3]
    pose, prims, dirs = args[:3]
    b_ms, b_by, ops, tests = bound_ms(torch, rc, pose, prims, dirs, args[4:7], n_tri, args[7],
                                      name, face)
    hit = ("" if k[1] is None else
           f", hit share {(k[1] != rc.oracle.NO_HIT_SEGMENTATION_VAL).float().mean().item():.4f}")
    log(f"timing {name} {tag} ({pose.shape[0]}x{tuple(dirs.shape[:-1])} rays, "
        f"{prims.shape[1]} prims{hit}): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms | "
        f"{bound_text(b_ms, b_by, ops, tests, ms)} | {card}")
    del k
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "max_abs_err": err, "tests_per_ray": tests}, face


def build_ab(torch, rc, ab_libs, args, n_tri, card):
    """K1 from the shipped build and from each BUILD_AB build of the same
    source, launched through the wrapper's ctypes types on the same inputs
    and timed by CUDA events in the order A B C C B A; each image compared
    with the shipped build's. -> {build: {ms, ms_each, vs_shipped,
    pixels_differing, max_abs_diff}}"""
    pose, prims, dirs, mult, n_box, n_cyl, n_sph, max_range = args
    (H, W), N, P = rc.ray_grid(dirs), pose.shape[0], prims.shape[1]
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(lib):
        so = rc.bind(lib.load())
        depth = torch.empty((N, H * W), device=pose.device)

        def run():
            code = so.raycast_launch(pose.data_ptr(), prims.data_ptr(), dirs.data_ptr(),
                                     mult.data_ptr(), depth.data_ptr(), None, None, None, N, H,
                                     W, P, n_box, n_cyl, n_sph, n_tri, float(max_range), 1,
                                     rc.MODE_DEPTH, stream)
            if code != 0:
                raise RuntimeError("A/B launch failed: " + so.raycast_error_string(code).decode())
            return depth
        return run

    shipped = "-fmad=false (shipped)"
    runs = {shipped: launcher(rc.LIBRARY), **dict(zip(BUILD_AB, map(launcher, ab_libs)))}
    times = {k: [] for k in runs}
    for k in list(runs) + list(reversed(runs)):
        times[k].append(event_ms(torch, runs[k], 5))
    base, out = runs[shipped](), {}
    for k, run in runs.items():
        diff = (run() - base).abs()
        ms = min(times[k])
        out[k] = {"ms": ms, "ms_each": times[k], "vs_shipped": ms / min(times[shipped]) - 1.0,
                  "pixels_differing": int((diff > 0).sum()), "max_abs_diff": diff.max().item()}
        log(f"build A/B {k}: K1 {ms:.3f} ms ({', '.join(f'{t:.3f}' for t in times[k])}), "
            f"{out[k]['vs_shipped']:+.1%} against the shipped build, image differs from it at "
            f"{out[k]['pixels_differing']} of {diff.numel()} rays (max {out[k]['max_abs_diff']:.3g})"
            f" | {N}x{H}x{W} rays, {P} prims | {card}")
        del diff
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-attention", metavar="FILE",
                    help="another attention.cu (the parent commit's): its bf16 serving kernel "
                         "is built beside the shipped one and timed with it in turns")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    from aerial_gym_simulator_tpu_torch.ops._build import KernelLibrary, build_all
    from aerial_gym_simulator_tpu_torch.ops.attention import (
        attention_backward_reference, attention_reference)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        camera_ray_dirs, cast_inputs, render_camera, sensor_world_pose)
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    dev = torch.device("cuda")
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")

    t_run = time.perf_counter()
    # 1. build: the two sources, and the ray cast's A/B variants beside them
    ab_libs = [KernelLibrary("raycast", flags) for flags in BUILD_AB.values()]
    labels = ["raycast", "attention"] + [f"raycast {k}" for k in BUILD_AB]
    parent_lib = []
    if args.parent_attention:
        parent_lib = [KernelLibrary("attention_parent", source=args.parent_attention)]
        labels.append("attention (parent)")
    t0 = time.perf_counter()
    build_logs = build_all([rc.LIBRARY, ac.LIBRARY, *ab_libs, *parent_lib])
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({rc.LIBRARY.path().name}, {ac.LIBRARY.path().name}; "
        f"{len(ab_libs)} A/B builds of raycast.cu alongside)")
    ptxas = {label: ptxas_kernels(build_log) for label, build_log in zip(labels, build_logs)}
    for label, kernels in ptxas.items():
        for name, info in kernels.items():
            log(f"  ptxas {label} {name}: {info.get('registers')} registers, spill stores "
                f"{info.get('spill_stores')} / loads {info.get('spill_loads')} bytes, static "
                f"shared memory {info.get('static_smem')} bytes")

    parent_fwd, parent_bwd = (parent_launchers(torch, parent_lib[0], args.parent_attention)
                              if parent_lib else (None, None))
    parent = (lambda q, k, v, H: parent_fwd(q, k, v, H, 1)) if parent_lib else None

    # 2. device
    card = card_line()
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 3")
    # 3. kernel vs plain version on the card
    errs = {"raycast_depth": 0.0, "raycast_seg": 0.0, "raycast_normals": 0.0, "raycast_rgb": 0.0}
    env = port.SimBuilder().build_env(*names, num_envs=64, seed=0)
    sp, sc = env.params.camera, env.params.scene
    R = sp.height * sp.width
    counts, n_tri = (sc.n_box, sc.n_cyl, sc.n_sph), sc.n_tri

    def render_args(params, state):
        """The kernel's inputs exactly as render_camera builds them."""
        cam, scene = params.camera, params.scene
        pos_w, quat_w = sensor_world_pose(cam, state, state.cam_mount_pos,
                                          state.cam_mount_quat)
        return (rc.pack_pose(pos_w, quat_w),
                rc.pack_prims_world(scene, state.obstacle_pos, state.obstacle_quat),
                cam.dirs, cam.depth_multiplier)

    def check_modes(args, n_tri, tag):
        """Every mode bit-equal to the plain version on one input."""
        for name in MODE_KW:
            errs[name] = max(errs[name], exact_check(torch, rc, args, n_tri, tag, name)[0])

    cnt = counts + (sp.max_range,)
    for tag in ("obstacles64/reset", "obstacles64/step20"):
        if tag.endswith("step20"):
            zeros64 = torch.zeros((64, 4), device=dev)
            for _ in range(20):
                env.step(zeros64)
        check_modes(render_args(env.params, env.state) + cnt, n_tri, tag)
    dirs_full = torch.as_tensor(camera_ray_dirs(135, 240, 87.0)[0], device=dev)
    syn_args, syn_counts = synthetic_scene(torch, rc, dirs_full, dev)
    check_modes(syn_args + syn_counts[:3] + (12.0,), syn_counts[3], "synthetic324")
    # the 360-degree lidar table: each 256-ray tile spans 180 degrees of azimuth
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_lidar", "lee_velocity_control",
                                      num_envs=64, seed=0)
    for _ in range(5):
        env.step(torch.zeros((64, 4), device=dev))
    st, lp = env.state, env.params.lidar
    lidar_args = cast_inputs(env.params, st, lp, st.lidar_mount_pos, st.lidar_mount_quat)
    check_modes(lidar_args, n_tri, "lidar64")
    del env, lidar_args, syn_args
    errs["attention_fwd"], k5_train_err, fwd_errs = compare_attention(torch, ac,
                                                                      attention_reference, dev)
    errs["attention_bwd"], bwd_errs = compare_attention_bwd(torch, ac, attention_backward_reference,
                                                            dev)
    if parent_lib:
        parent_compare(torch, ac, parent_fwd, parent_bwd, dev, card)

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 4")
    # 4. the slice at full width
    t0 = time.perf_counter()
    env = port.SimBuilder().build_env(*names, num_envs=NUM_ENVS, seed=0)
    torch.cuda.synchronize()
    log(f"slice: build_env({NUM_ENVS} envs) {time.perf_counter() - t0:.2f} s, "
        f"{env.params.scene.num_env_prims} prims/env")
    params = env.params
    zeros = torch.zeros((NUM_ENVS, 4), device=dev)
    env.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    state = env.state
    for _ in range(2):                                  # warm-up
        state = dynamics.env_step(params, state, zeros)
        depth, _ = render_camera(params, state, want_seg=False)
    torch.cuda.synchronize()
    steps = 10
    t0 = time.perf_counter()
    for _ in range(steps):
        state = dynamics.env_step(params, state, zeros)
        depth, _ = render_camera(params, state, want_seg=False)
    torch.cuda.synchronize()
    dt_depth = time.perf_counter() - t0
    if not (torch.isfinite(depth).all() and torch.isfinite(state.pos).all()):
        raise AssertionError("non-finite output in the depth loop")
    env.state = state
    seg_steps = 3
    t0 = time.perf_counter()
    for _ in range(seg_steps):
        env.step(zeros)
        env.render()
    torch.cuda.synchronize()
    dt_seg = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    obs = env.get_obs()
    if not (torch.isfinite(obs["depth_range_pixels"]).all()
            and obs["segmentation_pixels"].shape == (NUM_ENVS, sp.height, sp.width)):
        raise AssertionError("bad render() output")
    if launches["raycast_depth"] == 0 or launches["raycast_seg"] == 0:
        raise AssertionError(f"the main path did not launch every kernel: {launches}")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    rays = R * NUM_ENVS
    log(f"slice: depth loop {steps * NUM_ENVS / dt_depth:.1f} env-steps/s, "
        f"{steps * rays / dt_depth:.4g} rays/s ({dt_depth / steps * 1e3:.2f} ms/step) | {card}")
    log(f"slice: step+render(seg) {seg_steps * NUM_ENVS / dt_seg:.1f} env-steps/s "
        f"({dt_seg / seg_steps * 1e3:.2f} ms/step) | {card}")
    log(f"slice: launches {launches}, peak memory {peak_gb:.2f} GB, "
        f"crashes {int(obs['crashes'].sum())}/{NUM_ENVS}")

    # where the depth loop's time goes: its two halves timed apart
    step_ms = wall_ms(torch, lambda: dynamics.env_step(params, env.state, zeros))
    render_ms = wall_ms(torch, lambda: render_camera(params, env.state, want_seg=False))
    log(f"slice: breakdown env_step {step_ms:.2f} ms "
        f"({params.env.substep_mean} substeps), render_camera(depth) {render_ms:.2f} ms | {card}")

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 6a")
    # 6a. the ray cast at this path's shapes, while its env is in memory
    #     (the attention is timed after the nav phase)
    a, mr = render_args(params, env.state), sp.max_range
    sc = params.scene
    counts, n_tri = (sc.n_box, sc.n_cyl, sc.n_sph), sc.n_tri
    del obs, depth
    records = []
    for name in ("raycast_depth", "raycast_seg"):
        rec, _ = time_mode(torch, rc, a + counts + (mr,), n_tri, name, card, "obstacles")
        errs[name] = max(errs[name], rec["max_abs_err"])
        records.append({
            "name": name, "route": "cuda", "source": RAYCAST_SOURCE,
            "replaces": RAYCAST_REPLACES, "launches": launches[name], **rec,
            "max_abs_err": errs[name], "library_ms": None,
        })
    records[0]["build_ab"] = build_ab(torch, rc, ab_libs, a + counts + (mr,), n_tri, card)
    del a, env, state, params, zeros
    torch.cuda.empty_cache()

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 4b")
    # 4b. the normal/face-id and RGB captures at full width, then K3 and K4
    #     at this path's shapes while its inputs are in memory
    mod_launches, mod_args, mod_tri = modalities_phase(torch, port, rc, card)
    k3, face = time_mode(torch, rc, mod_args, mod_tri, "raycast_normals", card, "modalities")
    k4, _ = time_mode(torch, rc, mod_args, mod_tri, "raycast_rgb", card, "modalities", face)
    del mod_args, face
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 4c")
    # 4c. the lidar at 1024 envs, then K2 and K3 at its shapes
    lid_launches, lid_args, lid_tri = lidar_phase(torch, port, rc, card)
    k2_lidar, _ = time_mode(torch, rc, lid_args, lid_tri, "raycast_seg", card, "lidar")
    k3_lidar, _ = time_mode(torch, rc, lid_args, lid_tri, "raycast_normals", card, "lidar")
    del lid_args
    torch.cuda.empty_cache()
    lidar_tag = f"at_{LIDAR_ENVS}x{128 * 512}_lidar"
    records[1]["launches"] += mod_launches["raycast_seg"] + lid_launches["raycast_seg"]
    records[1]["launches_modalities_path"] = mod_launches["raycast_seg"]
    records[1][lidar_tag] = dict(k2_lidar, launches=lid_launches["raycast_seg"], library_ms=None)
    errs["raycast_seg"] = max(errs["raycast_seg"], k2_lidar["max_abs_err"])
    records[1]["max_abs_err"] = errs["raycast_seg"]
    mode_records = []
    for name, rec, sub in (("raycast_normals", k3, k3_lidar), ("raycast_rgb", k4, None)):
        record = {"name": name, "route": "cuda", "source": RAYCAST_SOURCE,
                  "replaces": RAYCAST_REPLACES, "launches": mod_launches[name],
                  **rec, "max_abs_err": max(errs[name], rec["max_abs_err"]), "library_ms": None}
        if sub is not None:
            # the lidar path: its launches beside its own time
            record["launches"] += lid_launches[name]
            record["launches_modalities_path"] = mod_launches[name]
            record[lidar_tag] = dict(sub, launches=lid_launches[name], library_ms=None)
            record["max_abs_err"] = max(record["max_abs_err"], sub["max_abs_err"])
        mode_records.append(record)

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 5")
    # 5. the navigation task flown by the shipped networks
    nav_launches, nav_k1_err, nav_check = nav_phase(torch, port, rc, ac, card)
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], nav_k1_err)
    records[0]["launches"] += nav_launches["raycast_depth"]
    records[0]["launches_nav_path"] = nav_launches["raycast_depth"]

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 6b")
    # 6b. the attention forward at the nav path's shape and type (bf16, the
    #     serving kernel) and at the training path's (f32, the TF32 kernel),
    #     the latter also at 4 heads (head_dim 64)
    k5 = time_attention(torch, ac, attention_reference, card, ATTENTION_MAIN_SHAPE, "bfloat16",
                        0.05, parent)
    k5_serving_hd64 = time_attention(torch, ac, attention_reference, card, SERVING_HD64_SHAPE,
                                     "bfloat16", 0.05, parent)
    # last: where the parent build refuses a launch, its runtime keeps the error
    k5_long = [time_attention(torch, ac, attention_reference, card, shape, "bfloat16", 0.05,
                              parent) for shape in LONG_SHAPES]
    k5_train = time_attention(torch, ac, attention_reference, card, ATTENTION_TRAIN_SHAPE,
                              "float32", 1e-4)
    k5_train["max_abs_err"] = max(k5_train["max_abs_err"], k5_train_err)
    k5_hd64 = time_attention(torch, ac, attention_reference, card, (TRAIN_BATCH, 225, 256, 4),
                             "float32", 1e-4)
    # the flash path (JAX impl "flash", K7): the f32 kernel on f32 copies of
    # the serving shape's bf16 tensors, and a flash-tagged shipped encoder
    k7 = flash_phase(torch, ac, attention_reference, card)
    shape_tag = lambda shape: "at_{}x{}x{}_bf16_{}_heads".format(*shape)
    records.append({
        "name": "attention_fwd", "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "launches": nav_launches["attention_fwd"],
        **k5, "max_abs_err": max(errs["attention_fwd"], k5["max_abs_err"]),
        "nav_check": nav_check,
        "ptxas": {k: v for k, v in ptxas["attention"].items()
                  if "attention_mma_kernel" in k or "attention_ring_kernel" in k},
        shape_tag(SERVING_HD64_SHAPE): k5_serving_hd64,
        **{shape_tag(shape): rec for shape, rec in zip(LONG_SHAPES, k5_long)},
        "at_64x225x256_f32": k5_train,      # the training path; its launches join below
        "at_64x225x256_f32_head_dim_64": k5_hd64,
        "flash_path_at_1024x225x256": k7,
    })

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 7")
    # 7. training: train_vae through the ViT with K5 and K6, then the conv VAE
    train_launches = train_phase(torch, rc, ac, card)
    records[0]["launches"] += train_launches["raycast_depth"]
    records[0]["launches_train_path"] = train_launches["raycast_depth"]
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 7b")
    # 7b. train_vae at one head: the one-pass wide kernels
    wide_launches = train_one_head_phase(torch, rc, ac, card, TRAIN_WIDE_ARGS, TRAIN_WIDE_STEPS,
                                         " (one head)")
    records[0]["launches"] += wide_launches["raycast_depth"]
    records[0]["launches_train_one_head_path"] = wide_launches["raycast_depth"]
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 7c")
    # 7c. train512: train_vae at dim 512, depth 12, one head: the cluster kernels
    cluster_launches = train_one_head_phase(torch, rc, ac, card, TRAIN512_ARGS, TRAIN512_STEPS,
                                            "512 (one head)", TRAIN512_PLAIN_TOL)
    records[0]["launches"] += cluster_launches["raycast_depth"]
    records[0]["launches_train512_path"] = cluster_launches["raycast_depth"]
    # each path's launches beside that path's own time and error: the top
    # level of K5's record is the nav path, the sub-record the training path
    records[2]["at_64x225x256_f32"]["launches"] = train_launches["attention_fwd"]

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 6c")
    # 6c. the attention backward at the training path's shape, and at the
    #     serving shape in bf16 beside it
    k6 = time_attention_bwd(torch, ac, attention_backward_reference, card,
                            ATTENTION_TRAIN_SHAPE, "float32", 2e-4)
    k6_bf16 = time_attention_bwd(torch, ac, attention_backward_reference, card,
                                 ATTENTION_MAIN_SHAPE, "bfloat16", 0.02)
    # the same width at 4 heads: head_dim 64 in f32
    k6_hd64 = time_attention_bwd(torch, ac, attention_backward_reference, card,
                                 (TRAIN_BATCH, 225, 256, 4), "float32", 2e-4)
    records.append({
        "name": "attention_bwd", "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_BWD_REPLACES, "launches": train_launches["attention_bwd"],
        "max_abs_err": max(errs["attention_bwd"], k6["max_abs_err"]), "ms": k6["ms"],
        "plain_ms": k6["plain_ms"], "bound_ms": k6["bound_ms"], "bound_by": k6["bound_by"],
        "library_ms": k6["library_ms"],
        "direct_ms": k6["direct_ms"],
        "at_1024x225x256_bf16": k6_bf16,
        "at_64x225x256_f32_head_dim_64": k6_hd64,
    })

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 6d")
    # 6d. the one-pass wide kernels at the one-head training path's shape
    #     (head_dim 256, f32) and the wide forward in bf16 at the serving
    #     batch; the cluster kernels at train512's shape (head_dim 512, f32)
    #     and the cluster forward in bf16 at the serving batch, each beside
    #     the sliced kernels on the same tensors
    k5_wide = time_attention(torch, ac, attention_reference, card, WIDE_HEAD_SHAPE, "float32",
                             1e-4)
    k5_wide_bf16 = time_attention(torch, ac, attention_reference, card, WIDE_SERVING_SHAPE,
                                  "bfloat16", 0.05)
    k6_wide = time_attention_bwd(torch, ac, attention_backward_reference, card, WIDE_HEAD_SHAPE,
                                 "float32", 2e-4)
    bf16_tag = lambda shape: "at_{}x{}x{}_bf16".format(*shape[:3])
    records.append(family_record("attention_fwd_wide", ATTENTION_REPLACES, wide_launches,
                                 k5_wide, fwd_errs, ptxas["attention"],
                                 **{bf16_tag(WIDE_SERVING_SHAPE): k5_wide_bf16}))
    records.append(family_record("attention_bwd_wide", ATTENTION_BWD_REPLACES, wide_launches,
                                 k6_wide, bwd_errs, ptxas["attention"]))
    occupancy = {dt: ac.cluster_occupancy(CLUSTER_SHAPE[2], getattr(torch, dt))
                 for dt in ("float32", "bfloat16")}
    log(f"timing cluster kernels at head_dim {CLUSTER_SHAPE[2]}: clusters of "
        f"{-(-CLUSTER_SHAPE[2] // ac.WIDE_HEAD)} blocks the card holds at once "
        f"(cudaOccupancyMaxActiveClusters) {occupancy} | {card}")
    k5_cluster = time_attention(torch, ac, attention_reference, card, CLUSTER_SHAPE, "float32",
                                1e-4)
    k5_cluster_bf16 = time_attention(torch, ac, attention_reference, card,
                                     CLUSTER_SERVING_SHAPE, "bfloat16", 0.05)
    k6_cluster = time_attention_bwd(torch, ac, attention_backward_reference, card,
                                    CLUSTER_SHAPE, "float32", 2e-4)
    records.append(family_record("attention_fwd_cluster", ATTENTION_REPLACES, cluster_launches,
                                 dict(k5_cluster, clusters_held=occupancy), fwd_errs,
                                 ptxas["attention"],
                                 **{bf16_tag(CLUSTER_SERVING_SHAPE): k5_cluster_bf16}))
    records.append(family_record("attention_bwd_cluster", ATTENTION_BWD_REPLACES,
                                 cluster_launches, k6_cluster, bwd_errs, ptxas["attention"]))

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 8")
    # 8. position PPO, the state-step line, the shipped position policy
    ppo_phase(torch, port, card)

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 9")
    # 9. navigation RL: navigation PPO with the ViT encoder (K1 + K5), the
    #    lidar task flown by its shipped MLP policy, the radar task flown by
    #    its shipped GRU policy and trained by recurrent PPO (K1 on the 48x120
    #    tables)
    navppo_launches, navppo_check, navppo_straight = navppo_phase(torch, port, rc, ac, card)
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 9 lidarnav")
    lidar_task, lidarnav_launches, k1_lidarnav = pointcloud_nav_phase(
        torch, port, rc, card, "lidar_navigation_task", LIDAR_NAV_POLICY, LIDARNAV_STEPS,
        "lidarnav")
    lidar_task.close()
    del lidar_task
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 9 radarnav")
    radar_task, radarnav_launches, k1_radarnav = pointcloud_nav_phase(
        torch, port, rc, card, "radar_navigation_task", RADAR_NAV_POLICY, RADARNAV_STEPS,
        "radarnav")
    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 9 radarnav ppo")
    radar_ppo_launches = radar_ppo_phase(torch, radar_task, rc, card)
    radar_task.close()
    del radar_task
    torch.cuda.empty_cache()
    k1_radarnav["launches"] += radar_ppo_launches["raycast_depth"]
    k1_radarnav["launches_ppo"] = radar_ppo_launches["raycast_depth"]
    records[0]["launches"] += (navppo_launches["raycast_depth"]
                               + lidarnav_launches["raycast_depth"]
                               + k1_radarnav["launches"])
    records[0]["launches_navppo_path"] = navppo_launches["raycast_depth"]
    tables = f"{LIDARNAV_ENVS}x{48 * 120}"
    records[0][f"at_{tables}_lidarnav"] = k1_lidarnav
    records[0][f"at_{tables}_radarnav"] = k1_radarnav
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], k1_lidarnav["max_abs_err"],
                                    k1_radarnav["max_abs_err"])
    records[2]["launches"] += navppo_launches["attention_fwd"]
    records[2]["launches_navppo_path"] = navppo_launches["attention_fwd"]
    records[2]["navppo_check"] = navppo_check

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 10 collision")
    # 10. collision labels: train_vae --collision_targets (K1 + K2 per step)
    collision_launches, k2_collision = collision_phase(torch, port, rc, ac, card)
    records[0]["launches"] += collision_launches["raycast_depth"]
    records[0]["launches_collision_path"] = collision_launches["raycast_depth"]
    records[1]["launches"] += collision_launches["raycast_seg"]
    records[1]["launches_collision_path"] = collision_launches["raycast_seg"]
    records[1][f"at_{TRAIN_BATCH}x{135 * 240}_collision"] = k2_collision
    records[1]["max_abs_err"] = max(records[1]["max_abs_err"], k2_collision["max_abs_err"])

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 11 variants")
    # 11. the position-task variants, PPO on the end-to-end task, the
    #     8-motor robots: state-only paths, no kernel launch
    variants_phase(torch, port, rc, ac, card)

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 12 plumbing")
    # 12. the training plumbing: the rl.ppo command line, exact resume of
    #     navigation PPO (K1 + K5), saved sim state (K2), the wrappers, the
    #     custom task and the reference-VAE importer (K1)
    plumbing = plumbing_phase(torch, port, rc, ac, card, navppo_straight)
    pl = plumbing["launches"]
    k1_plumbing = sum(pl[k]["raycast_depth"] for k in ("victim", "resumed", "vec_env",
                                                       "torch_vae"))
    records[0]["launches"] += k1_plumbing
    records[0]["launches_plumbing_path"] = k1_plumbing
    records[1]["launches"] += pl["sim_state"]["raycast_seg"]
    records[1]["launches_plumbing_path"] = pl["sim_state"]["raycast_seg"]
    k5_plumbing = pl["victim"]["attention_fwd"] + pl["resumed"]["attention_fwd"]
    records[2]["launches"] += k5_plumbing
    records[2]["launches_plumbing_path"] = k5_plumbing
    records[2]["plumbing_resume"] = plumbing["resume"]
    records[0]["plumbing_torch_vae_latent_err_vs_cpu"] = plumbing["torch_vae_latent_err_vs_cpu"]

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: all phases")
    log(json.dumps({"kernels": records + mode_records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
