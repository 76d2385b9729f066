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
               env_with_lidar_nav_obstacles) at 512 envs flown 220 steps
               (two episodes) by the shipped lidar_navigation_policy.npz:
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

 13. articulated - the articulated robots, the IMU and the sensor catalog:
               a. position_setpoint_task_reconfigurable (snakey6, 2 ms dt, 5
               substeps) and position_setpoint_task_morphy at their configs'
               1,024 envs, 100 steps each from seeded actions: observations
               (1024, 49) and (1024, 33), finite rewards, joints inside the
               URDF limits, ms/step, env-steps/s and the device's idle share;
               3 PPO iterations on the reconfigurable task at 1,024 x 32;
               morphy_fixed_base at 1,024 envs, 300 zero-thrust steps: the
               arms settle (|qd| < 0.2, |q| <= 0.25 + 1e-5, base velocity 0);
               b. one articulated_substep on the card and on the CPU from the
               same state, snakey6 and morphy at 1,024 envs, within
               SOLVER_TOL; c. base_quadrotor_with_imu hovering at 16,384 envs
               for 200 steps with imu_measurement every step (the bias walk's
               std within 15% of bias_std sqrt(T dt), mean z specific force
               about +9.81), base_quadrotor_with_camera_imu at 1,024 envs in
               the obstacle env for 20 steps of render() (K2 once a step); d.
               every new catalog camera and lidar on the camera / lidar quad
               in the obstacle env at 256 envs: render() once (K2; K1 for the
               four sensors without segmentation), K2 (and K1 there) on the
               capture's inputs bit-equal to the plain version, broad phase
               on and off, timed with its bound; each part's seconds.

14. scenes - the forest and dynamic scenes, stereo and multi-sensor capture,
               triangle meshes and the native URDF compiler: a. forest_env
               with the camera quad at 16,384 envs, 10 steps of env.step +
               render() (K2 once a step), K2 and K1 on its table timed with
               their bounds and bit-equal to the plain version on 64 envs; b.
               dynamic_env at 16,384 envs with the twist [0.1, 0.05, 0, 0, 0,
               0.2] on every slot for 20 steps with render() (K2): obstacles
               in the arena moved by steps x substeps x dt x v within 1e-4 m,
               one step on the card and on the CPU from the same state within
               tests/test_torch_dynamics.py's bars, K2 and K1 as in a; c.
               base_quadrotor_with_stereo_camera at 4,096 envs (270x480 per
               eye): env.step + render() (left eye K2, right eye K1), the
               capture equal to the range-limited max of the two eyes, each
               eye timed and bit-equal on 16 envs; two fixed cameras and the
               lidar on one quad at 1,024 envs: render() (K2 three times),
               each camera slice equal to the single-sensor render; d. a
               subdivision-4 icosphere STL (5,120 faces) decimated to 2,048
               triangles as two assets of env_with_obstacles with max_prims
               2,048 at 1,024 envs: env.step + render() + render("rgb") +
               the normal/face-id and the depth-only captures (K1-K4), each
               mode timed with its bound and bit-equal on 2 envs, the
               collision SDF 0.1 m outside the sphere within the
               tessellation's error; the forest's and the obstacle env's
               procedural URDFs as 1,024 files through the native batch
               loader and the Python parser, models equal, both timed; each
               part's seconds.

15. differentiable - differentiable training: a. ops/raycast_diff on the
               obstacle env's camera at 64 envs (135x240 grid): "kernel"
               (K1) bit-equal to raycast_reference, edge flips against the
               oracle under 0.1% of the rays and the rest within 2e-3 m;
               the pose gradients on the card against the CPU's on 2 envs
               within 1e-3 of the largest; 20 steps of the inverse
               rendering of tests/test_raycast_diff.py (Adam at lr 0.02 on
               the obstacle positions from a seeded 0.15 m perturbation) at
               this width, each step's K1 forward and oracle backward
               timed, peak memory and the device's idle share, the loss
               falling; K1 on this table timed with its bound; then the
               recipe on its own 2-env scene and 8x128 table for 150 steps,
               the loss below 5% of its start; b. d/d tau and d/d drag of tests/test_differentiable.py's
               12-step rollout on the card against the CPU, 1e-3 relative;
               c. rl.bptt at BPTTConfig's defaults (256 envs x 16) for 150
               iterations: best task-reward EMA above max(3, 2 r0), s per
               iteration and its forward / backward split, idle share, then
               two windows with remat against without (gradients within
               1e-6, generator states equal); d. the rl.population command
               line (8 members x 1,024 envs x 32, lr sweep, PBT every
               iteration, --save_best): finite rewards, aggregate
               env-steps/s, the saved best member acting bit-equal, and
               member 0 of a 2-member population bit-equal to a standalone
               trainer; each part's seconds.

16. parallel - multi-process training: two processes on the one card joined
               by torch.distributed (gloo: NCCL refuses two ranks on one
               device; the backend printed), each rank a block of the env
               axis: a. a global sum of CUDA tensors across the ranks; b.
               navigation PPO (NAVPPO_ARGS + --multichip: 1,024 global envs
               x 32, the shipped ViT, each rank's task built at its block),
               its carry, observation, scene tables and generators at build
               bit-equal to the build-then-cut rank's (built beside it for
               its memory), then 2 iterations, the learner
               bit-identical on both ranks, s/iteration beside phase 9's
               one-rank run, each rank's K1 and K5 launches; before it, 8
               steps under seeded actions from the trainer's start against
               a one-rank task of the same seed: depth images and the
               observations' state columns bit-equal, their bf16 ViT latents
               within PAR_LATENT_TOL; c. LiDAR-navigation PPO, 2 x
               256 envs, one iteration (K1 on the 48x120 table), learner
               identical; d. b's training state saved by both ranks and
               restored into a one-rank trainer: parameters, Adam, norm
               bit-equal, the carry equal to the gathered one; e. the
               tensor-parallel ViT (the shipped encoder in f32, 4 heads a
               rank, batch 1,024) within 2e-5 of the whole encoder, K5 on
               each rank's heads; f. a population of 4 members x 1,024 envs
               (PBT every iteration) dealt over the ranks, only this rank's
               members built, every member bit-equal to the unsharded
               population's; g. the rehearsals'
               legs in the ranks' own processes: position PPO at 2 x 1,024
               envs over both ranks, then at 1,024 and 2,048 on one rank,
               env-steps/s and the weak and strong ratios (harness checks on
               a shared card, not efficiencies); each part's seconds, and
               each rank's peak and held memory at the builds of b (at its
               block and built then cut) and f.
17. deploy - deployment and the viewers: a. the OfflineViewer (320x240) on
               the obstacle env at 16,384 envs, 20 frames in follow mode and
               20 in fixed mode, env.step between frames: each frame's K2
               (env i's primitive rows, the world-frame chase grid) bit-equal
               to the plain version, one launch a frame, K2 ms and
               whole-frame ms, an .avi written; b. a LiveViewer taking the
               key map and a WebViewer on 127.0.0.1 (an ephemeral port):
               /frame.png a PNG, /key POSTs reaching the key map, /status
               polled to a deadline; c. the shipped position policy ->
               build_deploy_module -> torch.jit.script -> save -> load on the
               card, its actions on 8,192 observations of the position task
               within 1e-5 of the port's MLPPolicy, rescale_actions onto
               limits; the shipped radar GRU policy through
               RecurrentPolicyDeploy for 20 steps with its hidden state
               carried (and a reset) against RecurrentPolicy; d.
               RL_Nav_Interface on the shipped navigation policy, fed 20
               steps of the navigation task at 1,024 envs encoded by the
               shipped conv VAE (K1 every step), its actions equal to the
               port's policy on the same observations; e. NavPolicyNode over
               the ROS loopback at 20x real time for 2 s, fed env 0's
               odometry: the command count, the first command against the
               policy run directly; each part's seconds.
18. tools - the utilities and the capability examples: a. the profiler
               (utils/profiling): its command line on position_setpoint_task
               at 16,384 envs, 10 iterations (the bench state step), its
               profile_task on the navigation task at 1,024 envs with the
               shipped ViT, 3 iterations (K1 once and K5 four times a step;
               the table names both kernels), and --ppo on the position task
               at 1,024 envs x 32, 1 iteration: a non-empty op table for
               each, wall ms, summed device ms and the device's idle share;
               b. the examples in process at the JAX scripts' widths, their
               iteration counts and two depths cut (SYSID_ARGS, TRAJ_ARGS,
               TUNE_ARGS): bem_standalone (the single rotor on the card
               against the CPU within 1e-5 of the wrench's largest
               component, the quad's four rotors, a 16,384 x 4 rotor batch
               timed and its first rotors against the CPU), sys_id (both
               schemes against the CPU within 1e-6), imu_data_collection
               (200 steps, finite rows), differentiable_sysid_example (4
               envs x 100 steps, 2 Adam iterations: the first gradient
               within 1e-3 relative of the CPU's, the loss falling),
               trajectory_optimization_example (1 env x 100 steps, 3
               iterations: the cost falling after the first step's
               overshoot, as in the JAX script), tune_controllers (the four
               step responses at 256 envs x 100 steps, finite metrics; then
               the --grad tuning at 60 steps for 2 iterations, the cost
               falling); each example's seconds per iteration.

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
NAVPPO_ITERATIONS = 2              # navigation PPO at NAV_ENVS x PPOConfig's horizon (32)
NAVPPO_ARGS = ["--task", "navigation_task", "--num_envs", str(NAV_ENVS), "--horizon", "32",
               "--seed", "7", "--vae_params", str(NETWORKS / "vit_depth_encoder.pkl")]
RESUME_AT = 1                      # plumbing: the victim run's iterations
CLI_ARGS = ["--task", "position_setpoint_task", "--num_envs", "8192", "--horizon", "32",
            "--total_steps", str(3 * 8192 * 32)]      # 3 iterations at ppo_aerial_quad.yaml's width
SIM_STATE_ENVS = 1024
CUSTOM_ENVS = 16384
VAE_CPU_IMAGES = 16                # images encoded on the card and on the CPU
LIDARNAV_ENVS = 512                # the lidar and radar recipes' envs
LIDARNAV_STEPS = 220               # at most two 110-step episodes
RADARNAV_STEPS = 450               # at most: the JAX package's bar for the shipped radar policy
POINTCLOUD_MIN_STEPS = 110         # both flights end at the first success after one episode
RADAR_PPO_ITERATIONS = 2
RADAR_RNN_HIDDEN = 128             # the radar recipe's GRU
LIDAR_NAV_POLICY = NETWORKS / "lidar_navigation_policy.npz"
RADAR_NAV_POLICY = NETWORKS / "radar_navigation_policy.npz"
COLLISION_STEPS = 30               # train_vae --collision_targets at the JAX CLI's defaults
COLLISION_ARGS = ["--arch", "conv", "--collision_targets", "--log_every", "1"]
VARIANT_STEPS = 50
VARIANT_TASKS = {                  # name -> the observation width; each at its config's envs
    "position_setpoint_task_sim2real": 17,
    "position_setpoint_task_acceleration_sim2real": 17,
    "position_setpoint_task_sim2real_end_to_end": 15,
    "position_setpoint_task_sim2real_px4": 15,
}
VARIANT_PPO_TASK = "position_setpoint_task_sim2real_end_to_end"
VARIANT_PPO_ENVS = 4096
VARIANT_PPO_ITERATIONS = 2
ROBOT_ENVS = 1024
ROBOT_STEPS = 50
ROBOT_PAIRS = (("base_octarotor", "lee_position_control"),
               ("base_random", "lee_position_control"),
               ("base_rov", "rov_fully_actuated_control"))
ART_TASKS = {                      # name -> the observation width; each at its config's 1,024 envs
    "position_setpoint_task_reconfigurable": 49,
    "position_setpoint_task_morphy": 33,
}
ART_STEPS = 30
ART_PPO_TASK = "position_setpoint_task_reconfigurable"
ART_PPO_ENVS = 1024
ART_PPO_ITERATIONS = 2
FIXED_BASE_ENVS = 1024
FIXED_BASE_STEPS = 300             # tests/test_articulated.py:289-307's settling run
SOLVER_ENVS = 1024
SOLVER_ROBOTS = (("snakey6", "base_sim_2ms"), ("morphy", "base_sim_2ms"))
# one substep on the card against the CPU, the bars of the CPU tests' twenty
# steps (tests/test_torch_articulated.py): the solve's rounding differs
SOLVER_TOL = {"pos": 1e-4, "quat": 1e-4, "dof_pos": 1e-4, "linvel": 1e-3, "angvel": 1e-3,
              "dof_vel": 1e-3}
IMU_ENVS = 16384
IMU_STEPS = 200
CAMERA_IMU_ENVS = 1024
CAMERA_IMU_STEPS = 20
CATALOG_ENVS = 256
CATALOG_CAMERAS = ("NavDepthCameraConfig", "RsD455Config", "TofCameraConfig",
                   "LuxonisOakDConfig", "LuxonisOakDProWConfig")
CATALOG_LIDARS = ("LidarNavConfig", "OS0_64Config", "OS0_128Config", "OS1_64Config",
                  "OS2_64Config", "OS2_128Config", "PmdFlexx2Config", "StVL53L5CXConfig",
                  "OSDome_64Config", "Lidar2DConfig")
SCENE_ENVS = 16384                 # forest and dynamic scenes: the obstacle loop's width
SCENE_STEPS = 10
DYNAMIC_STEPS = 10
DYNAMIC_TWIST = [0.1, 0.05, 0.0, 0.0, 0.0, 0.2]   # examples/dynamic_env_example.py's
STEREO_ENVS = 4096                 # x 270 x 480 rays per eye: the obstacle loop's ray count
STEREO_STEPS = 3
TWIN_ENVS = 1024
MESH_ENVS = 1024
MESH_STEPS = 3
MESH_SUBDIV = 4                    # 5,120 faces
MESH_RADIUS = 0.8
MESH_BUDGET = 2048                 # the triangle budget and max_prims of the mesh scene
MESH_CHECK_ENVS = 2                # the plain version's bit-equality check (5-7 s a mode, launch-bound)
LOADER_FILES = 1024
DIFF_ENVS = 64                     # 15a: the differentiable ray cast at the camera's full table
DIFF_GRAD_ENVS = 2                 # its gradient, card against CPU, on the first envs
DIFF_EDGE_SHARE = 1e-3             # kernel vs oracle: share of edge flips allowed (seg bar 0.999)
DIFF_STEPS = 40                    # inverse rendering: tests/test_raycast_diff.py's recipe (0.84 s
                                   # a step on the card, launch-bound: 40 of its 150 steps)
DIFF_TIMED_STEPS = 3               # the same descent at the full table, timed
DIFF_LR = 0.02
DIFF_PERTURB = 0.15
ROLLOUT_STEPS = 12                 # 15b: tests/test_differentiable.py's rollout
BPTT_ITERS = 10                    # 15c: BPTT at BPTTConfig's defaults (256 envs x 16)
POP_ARGS = ["--num_envs", "1024", "--num_seeds", "8", "--horizon", "32", "--total_steps",
            "65536", "--lr_sweep", "1e-4", "1e-3", "--pbt_every", "1"]   # 15d: 2 iterations
POP_COMPARE_ENVS = 1024            # member 0 against a standalone trainer
PAR_RANKS = 2                      # 16: two processes on the one card (gloo)
PAR_NAV_ITERATIONS = 2             # navigation PPO at NAV_ENVS global envs x 32, NAVPPO_ARGS
PAR_DRAW_STEPS = 8                 # 2-rank vs 1-rank steps under seeded actions
PAR_LATENT_TOL = 0.05              # the observations' ViT latents (atol = rtol): its bf16 products
                                   # round by the row count (tests/test_torch_models.py's bf16 bar)
PAR_LIDAR_ENVS = 512               # 2 ranks x 256
PAR_LIDAR_HORIZON = 32
PAR_TP_BATCH = 1024                # the tensor-parallel ViT: the shipped width, f32
PAR_TP_TOL = 2e-5                  # JAX tests/test_vit.py:74
PAR_POP = dict(num_seeds=4, num_envs=1024, horizon=32, iterations=2)
PAR_REHEARSAL = dict(envs_per_device=1024, horizon=16, warmup_iters=1, timed_iters=4)
PAR_TIMEOUT = 420.0
VIEWER_ENVS = 16384                # 17a: the obstacle loop's width
VIEWER_SIZE = (320, 240)           # the OfflineViewer's default frame
VIEWER_FRAMES = 10                 # a camera mode
DEPLOY_OBS = 8192                  # 17c: PPOConfig's num_envs
DEPLOY_RADAR_STEPS = 20
DEPLOY_TOL = 1e-5                  # JAX tests/test_aux_utils.py's bar for the deployed actor
DEPLOY_LIMITS = ([-2.0, -2.0, -1.0, -0.5], [2.0, 2.0, 1.0, 0.5])
DEPLOY_NAV_STEPS = 20              # 17d, at NAV_ENVS
ROS_RATE_SCALE = 20.0              # 17e: 20x real time, the node's 10 Hz -> 200 Hz
ROS_SECONDS = 2.0
DEADLINE_S = 60.0                  # every wait in 17b and 17e polls against it
PROFILE_STATE_ARGS = ["--task", "position_setpoint_task", "--num_envs", "16384", "--iters", "10"]
PROFILE_NAV_ITERS = 3              # 18a: the navigation step at NAV_ENVS with the shipped ViT
PROFILE_PPO_ARGS = ["--task", "position_setpoint_task", "--num_envs", "1024", "--ppo",
                    "--horizon", "32", "--iters", "1"]
BEM_CONDITIONS = [(2000.0, 0.0, 0.0, 0.0, 0.0, 1.0),   # 18b: omega, v_hor, v_ver, p, q, spin
                  (2200.0, 5.0, -1.0, 0.5, -0.3, 1.0), (1500.0, 0.0, 2.0, 0.0, 0.0, -1.0)]
BEM_TOL = 1e-5                     # card vs CPU, of the wrench's largest component
BEM_BATCH = (16384, 4)             # rotors: the obstacle loop's envs x a quad's motors
BEM_CHECK_ROTORS = 64              # the batch's first rotors against the CPU
BEM_BATCH_TOL = 1e-4
# 18b's iteration counts: each example iteration is a whole eager rollout (and
# its backward) of 100-400 launch-bound steps, 26-62 ms a step on the card's
# host; the JAX defaults would take minutes
SYSID_ARGS = dict(num_envs=4, steps=100, iters=2)      # of 300 Adam iterations
TRAJ_ARGS = dict(steps=100, iters=3)                   # of 1,000
TUNE_ARGS = dict(num_envs=256, steps=100, grad_iters=2, grad_steps=60)   # of 400 steps; 150
                                                       # iterations of a 120-step rollout
IMU_COLLECT_STEPS = 200            # of the JAX default 2,000
TOOLS_DEVICE = "cuda"              # phase 18's explicit tensors (a CPU rehearsal sets "cpu")
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


def sweep_counts(torch, rc, pose, prims, dirs, counts, max_range, env_chunk=512):
    """The mode-independent part of ``bound_ms``: (f32 operations of the
    rays and of the tests a bounding-sphere broad phase cannot skip, with
    their staged constants; {"needed", "patches", "strips": tests}).
    ``env_chunk`` envs are counted at a time (fewer for a table of
    thousands of primitives)."""
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
    for lo in range(0, N, env_chunk):
        ps, pr = pose[lo:lo + env_chunk], prims[lo:lo + env_chunk]
        need = rc.bounding_sphere_hits(ps, pr, dirs, *counts, max_range)        # (n, P)
        ops += float((need * flops_per_prim).sum() + ((need > 0) * stage_per_prim).sum())
        tests["needed"] += float(need.sum())
        for k, g in groups.items():
            vis = rc.tile_visibility(ps, pr, dirs, *counts, max_range, g)      # (n, G, P)
            tests[k] += float((vis.float() * sizes[k][None, :, None]).sum())
    return ops, tests


def bound_ms(torch, rc, pose, prims, dirs, counts, n_tri, max_range, name, face=None,
             env_chunk=512, sweep=None):
    """Least time for this call's work on the card: the larger of the bytes
    it must move (inputs once, outputs once) over 3.35 TB/s and the f32
    operations over 67 TFLOP/s: each ray's own, the (ray, primitive) tests
    that a broad phase on the primitives' bounding spheres could not skip
    (the ray's half-line meets the sphere within max_range:
    rc.bounding_sphere_hits), whatever the tiling, and the staged constants
    of each (env, primitive) pair among them; for the normal and RGB modes,
    plus the winner's normal (and shade) on each ray that ``face`` says hit.
    ``sweep`` is sweep_counts' result on these inputs, when the caller has
    it from another mode.

    Returns (ms, "bytes" or "operations", operations, tests per ray): the
    tests per ray that bound counts ("needed"), and those the kernel's
    broad phase keeps with its 8 x 8 warp patches ("patches") and with the
    256-ray strips of the kernel before them ("strips")."""
    N, P = pose.shape[0], prims.shape[1]
    R = dirs.numel() // 3
    ops, tests = sweep or sweep_counts(torch, rc, pose, prims, dirs, counts, max_range,
                                       env_chunk)
    if name in ("raycast_normals", "raycast_rgb"):
        kinds = [rc._kind_of(p, *counts) for p in range(P)]
        per_prim = torch.tensor([float(NORMAL_FLOPS[k]) for k in kinds], device=dirs.device)
        per_prim += SHADE_FLOPS if name == "raycast_rgb" else 0.0
        for lo in range(0, N, env_chunk):
            f = face[lo:lo + env_chunk]
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


def fly(torch, task, policy, steps, recurrent=False, min_steps=None):
    """Closed loop: policy(obs) -> task.step, outcomes summed on the device;
    a recurrent policy's hidden state is zeroed where an episode ended.
    With ``min_steps`` the flight ends at the first step after min_steps
    steps by which a success was counted. -> (seconds, [successes,
    crashes, timeouts], steps flown)."""
    obs, *_ = task.reset()
    totals = torch.zeros(3, device=task.device)
    finite = torch.ones((), dtype=torch.bool, device=task.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for taken in range(1, steps + 1):
        act = policy(obs["observations"])
        obs, rew, term, trunc, info = task.step(act)
        if recurrent:
            policy.reset((term > 0) | (trunc > 0))
        totals += torch.stack([info["successes"].sum(), info["crashes"].sum(),
                               info["timeouts"].sum()])
        finite &= (torch.isfinite(act).all() & torch.isfinite(rew).all()
                   & torch.isfinite(obs["observations"]).all())
        if min_steps is not None and taken >= min_steps and totals[0].item() > 0:
            break
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("non-finite action, reward or observation in the nav loop")
    if obs["observations"].shape != (task.num_envs, task.task_config.observation_space_dim):
        raise AssertionError(f"observation shape {tuple(obs['observations'].shape)}")
    return dt, [float(x) for x in totals], taken


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
    dt, (succ, crash, timo), _ = fly(torch, task, policy, NAV_STEPS)
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
    dt, (succ, crash, timo), _ = fly(torch, conv_task, conv_policy, NAV_CONV_STEPS)
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
    history = ppo_iterations(torch, trainer, NAVPPO_ITERATIONS, "navppo", card)
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    walls = [m["wall_s"] for m in history]
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
    log(f"navppo: split of iteration {NAVPPO_ITERATIONS + 1}: rollout {t_roll:.1f} ms "
        f"({t_roll / ppo_cfg.horizon:.2f} ms per env step), update {t_upd:.1f} ms ({n_mb} minibatch steps, {t_upd / n_mb:.2f} "
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
                      "s_per_iteration": [b - a for a, b in zip([0.0] + walls[:-1], walls)],
                      "device_idle_share": {k: 1.0 - b / w for k, (w, b) in busy.items()}}, straight


def nav_split(torch, task, policy, parts, tag, card):
    """Each piece of the step timed apart on the final state."""
    split = {name: wall_ms(torch, fn, 5) for name, fn in parts.items()}
    log(f"{tag}: split " + ", ".join(f"{k} {v:.2f} ms" for k, v in split.items())
        + f" | {card}")
    return split


def pointcloud_nav_phase(torch, port, rc, card, task_name, policy_file, max_steps, tag):
    """A pointcloud navigation task at LIDARNAV_ENVS envs flown by a shipped
    policy through the port's loader (per-env hidden resets for a recurrent
    one) until its first success after POINTCLOUD_MIN_STEPS steps, at most
    ``max_steps``: finite actions, at least one success, K1 once per step on
    the 48x120 table; the step's split (env_step, render, pointcloud
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
    dt, (succ, crash, timo), steps = fly(torch, task, policy, max_steps, recurrent,
                                        POINTCLOUD_MIN_STEPS)
    launches = dict(rc.LAUNCHES)
    ended = succ + crash + timo
    share = succ / max(ended, 1.0)
    log(f"{tag}: {steps} steps (at most {max_steps}) {steps * LIDARNAV_ENVS / dt:.1f} "
        f"env-steps/s ({dt / steps * 1e3:.2f} ms/step) | {card}")
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
    log(f"variants ppo: split of iteration {VARIANT_PPO_ITERATIONS + 1}: rollout {t_roll:.1f} ms "
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


def articulated_tasks_subphase(torch, port, card):
    """13a: the reconfigurable and morphy tasks at their configs' envs from
    seeded actions, PPO on the reconfigurable task, morphy_fixed_base's arms
    settling. Returns the device-busy readings."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
    busy = {}
    for name, obs_dim in ART_TASKS.items():
        task = port.task_registry.make_task(name)
        n, A, dp = task.num_envs, task.action_space_dim, task.params.dof
        gen = torch.Generator(device=task.device).manual_seed(0)
        actions = torch.rand((ART_STEPS, n, A), generator=gen, device=task.device)
        obs, *_ = task.reset()
        totals = torch.zeros(3, device=task.device)
        ok = torch.ones((), dtype=torch.bool, device=task.device)
        task.step(actions[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in actions:
            obs, rew, term, trunc, _ = task.step(a)
            q = task.state.dof_pos
            totals += torch.stack([rew.mean(), term.sum(), trunc.sum()])
            ok &= (torch.isfinite(obs["observations"]).all() & torch.isfinite(rew).all()
                   & ((q >= dp.lower_limit - 1e-5) & (q <= dp.upper_limit + 1e-5)).all())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        busy[name] = device_busy(torch, lambda: task.step(actions[0]), 5)
        reward_mean, crashes, truncations = (float(x) for x in totals)
        cfg = task.task_config
        log(f"articulated: {name} ({cfg.robot_name}, {cfg.sim_name}, {cfg.controller_name}) "
            f"{n} envs, {ART_STEPS} steps: {ART_STEPS * n / dt:.1f} env-steps/s "
            f"({dt / ART_STEPS * 1e3:.2f} ms/step, {task.params.env.substep_mean} substeps of "
            f"{task.params.art.nb} bodies), reward mean {reward_mean / ART_STEPS:.4f}, crashes "
            f"{crashes:.0f}, truncations {truncations:.0f}, finite and inside the joint limits "
            f"{bool(ok)} | {busy_text(*busy[name])} | {card}")
        shape = tuple(obs["observations"].shape)
        if not bool(ok) or shape != (n, obs_dim) or tuple(rew.shape) != (n,):
            raise AssertionError(f"articulated: {name}: finite and inside {bool(ok)}, "
                                 f"obs {shape}")
        task.close()
        del task, actions

    task = port.task_registry.make_task(ART_PPO_TASK, num_envs=ART_PPO_ENVS)
    trainer = PPOTrainer(task, PPOConfig(num_envs=ART_PPO_ENVS))
    ppo_iterations(torch, trainer, ART_PPO_ITERATIONS, "articulated ppo", card)
    if task._carry is not trainer.env_carry:
        raise AssertionError("articulated ppo: set_carry did not hand the carry back")
    task.close()
    del trainer, task

    env = port.SimBuilder().build_env("base_sim", "empty_env", "morphy_fixed_base",
                                      "no_control", num_envs=FIXED_BASE_ENVS, seed=0)
    zeros = torch.zeros((FIXED_BASE_ENVS, 4), device=env.device)
    q0 = env.state.dof_pos.clone()
    t0 = time.perf_counter()
    for _ in range(FIXED_BASE_STEPS):
        env.step(zeros)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    st = env.state
    qd_max, q_max = float(st.dof_vel.abs().max()), float(st.dof_pos.abs().max())
    base = float(st.linvel.abs().max()) + float(st.angvel.abs().max())
    log(f"articulated: morphy_fixed_base {FIXED_BASE_ENVS} envs, {FIXED_BASE_STEPS} steps of "
        f"zero thrust from q0 in [{float(q0.min()):.2f}, {float(q0.max()):.2f}]: max |qd| "
        f"{qd_max:.4g} (bar 0.2), max |q| {q_max:.6f} (bar 0.25 + 1e-5), base velocity "
        f"{base} (bar 0), {dt / FIXED_BASE_STEPS * 1e3:.2f} ms/step | {card}")
    if not (qd_max < 0.2 and q_max <= 0.25 + 1e-5 and base == 0.0):
        raise AssertionError("articulated: morphy_fixed_base's arms did not settle")
    del env
    return busy


def solver_subphase(torch, port, card):
    """13b: one articulated_substep on the card and on the CPU from the same
    state (joints in motion, targets, a spinning base, thrusts and a base
    wrench), each robot at SOLVER_ENVS envs: every field within SOLVER_TOL,
    the IMU's specific force within 1e-3 of its largest magnitude."""
    from aerial_gym_simulator_tpu_torch.sim.articulated import articulated_substep
    from aerial_gym_simulator_tpu_torch.sim.convert import (
        params_from_numpy, record_to_numpy, state_from_numpy)
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    for robot, sim in SOLVER_ROBOTS:
        env = port.SimBuilder().build_env(sim, "empty_env", robot, "no_control",
                                          num_envs=SOLVER_ENVS, seed=1)
        p, n, dev = env.params, SOLVER_ENVS, env.device
        D, M = p.dof.num_dofs, p.motor.num_motors
        g = torch.Generator(device=dev).manual_seed(2)
        u = lambda *shape: torch.rand(shape, generator=g, device=dev)
        lo, hi = p.dof.lower_limit, p.dof.upper_limit
        st = replace(env.state, dof_pos=0.8 * (lo + (hi - lo) * u(n, D)),
                     dof_vel=2 * u(n, D) - 1, dof_vel_target=2 * u(n, D) - 1,
                     dof_pos_target=0.4 * u(n, D) - 0.2, angvel=2 * u(n, 3) - 1,
                     linvel=2 * u(n, 3) - 1)
        wrench = (u(n, 3) - 0.5, 0.04 * u(n, 3) - 0.02, 3.0 * u(n, M))
        card_out = articulated_substep(p, st, *wrench)
        cpu_out = articulated_substep(params_from_numpy(record_to_numpy(p), "cpu"),
                                      state_from_numpy(record_to_numpy(st), "cpu"),
                                      *(w.cpu() for w in wrench))
        errs = {f: (getattr(card_out, f).cpu() - getattr(cpu_out, f)).abs().max().item()
                for f in list(SOLVER_TOL) + ["applied_force_b"]}
        spec_scale = cpu_out.applied_force_b.abs().max().item()
        ms = wall_ms(torch, lambda: articulated_substep(p, st, *wrench), iters=10)
        busy = device_busy(torch, lambda: articulated_substep(p, st, *wrench), 10)
        moved = (card_out.dof_vel - st.dof_vel).abs().max().item()
        log(f"articulated: solver {robot} ({p.art.nb} bodies, H {6 + D}x{6 + D}) at {n} envs, "
            f"card against CPU: " + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
            + f" (specific force up to {spec_scale:.3g}); joint rates moved {moved:.3g}; "
            f"{ms:.3f} ms per substep on the card, {busy_text(*busy)} | {card}")
        bad = [k for k, tol in SOLVER_TOL.items() if not errs[k] <= tol]
        if bad or not errs["applied_force_b"] <= 1e-3 * spec_scale or not moved > 1e-3:
            raise AssertionError(f"articulated: solver {robot}: {bad} beyond {SOLVER_TOL}, "
                                 f"errors {errs}")
        del env


def imu_subphase(torch, port, rc, card):
    """13c: base_quadrotor_with_imu holding a hover at IMU_ENVS envs with an
    IMU reading every step (bias walk from zero: its std within 15% of
    bias_std sqrt(T dt), the mean z specific force about +9.81 m/s^2), then
    base_quadrotor_with_camera_imu at CAMERA_IMU_ENVS envs in the obstacle
    env with render() and the IMU every step. Returns the second run's
    ray-cast launches."""
    from aerial_gym_simulator_tpu_torch.sensors.imu import imu_measurement
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor_with_imu",
                                      "lee_position_control", num_envs=IMU_ENVS, seed=3)
    n, dev = IMU_ENVS, env.device
    z3 = torch.zeros((n, 3), device=dev)
    env.state = replace(env.state, pos=z3, linvel=z3, angvel=z3, imu_accel_bias=z3,
                        imu_gyro_bias=z3,
                        quat=torch.tensor([0.0, 0.0, 0.0, 1.0], device=dev).expand(n, 4).clone())
    zeros = torch.zeros((n, 4), device=dev)
    acc_z = torch.zeros((), device=dev)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(IMU_STEPS):
        env.step(zeros)
        accel, gyro, ab, gb = imu_measurement(env.params, env.state)
        env.state = replace(env.state, imu_accel_bias=ab, imu_gyro_bias=gb)
        finite &= torch.isfinite(accel).all() & torch.isfinite(gyro).all()
        if k >= IMU_STEPS // 2:
            acc_z += accel[:, 2].mean()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    ip = env.params.imu
    expected = float(ip.accel_bias_std.mean()) * math.sqrt(IMU_STEPS * env.params.dt)
    measured = float(env.state.imu_accel_bias.std())
    mean_z = float(acc_z) / (IMU_STEPS - IMU_STEPS // 2)
    log(f"articulated: imu hover, base_quadrotor_with_imu + lee_position_control, {n} envs, "
        f"{IMU_STEPS} steps of env.step + imu_measurement: {IMU_STEPS * n / dt:.1f} env-steps/s "
        f"({dt / IMU_STEPS * 1e3:.2f} ms/step); accel bias std {measured:.4g} against "
        f"{expected:.4g} ({measured / expected - 1.0:+.1%}, bar 15%), mean z specific force "
        f"{mean_z:.4f} m/s^2 over the last {IMU_STEPS - IMU_STEPS // 2} steps, finite "
        f"{bool(finite)} | {card}")
    if not (bool(finite) and 0.85 * expected < measured < 1.15 * expected
            and abs(mean_z - 9.81) < 0.2):
        raise AssertionError("articulated: the IMU's bias walk or specific force is off")
    del env

    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera_imu", "lee_velocity_control",
                                      num_envs=CAMERA_IMU_ENVS, seed=4)
    zeros = torch.zeros((CAMERA_IMU_ENVS, 4), device=dev)
    zero_counts(rc.LAUNCHES)
    finite = torch.ones((), dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(CAMERA_IMU_STEPS):
        env.step(zeros)
        env.render()
        accel, gyro, ab, gb = imu_measurement(env.params, env.state)
        env.state = replace(env.state, imu_accel_bias=ab, imu_gyro_bias=gb)
        finite &= (torch.isfinite(env.get_obs()["depth_range_pixels"]).all()
                   & torch.isfinite(accel).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(rc.LAUNCHES)
    log(f"articulated: base_quadrotor_with_camera_imu, {CAMERA_IMU_ENVS} envs, "
        f"{CAMERA_IMU_STEPS} steps of env.step + render() + imu_measurement: "
        f"{dt / CAMERA_IMU_STEPS * 1e3:.2f} ms/step, launches {launches}, finite "
        f"{bool(finite)} | {card}")
    want = {"raycast_depth": 0, "raycast_seg": CAMERA_IMU_STEPS, "raycast_normals": 0,
            "raycast_rgb": 0}
    if launches != want or not bool(finite):
        raise AssertionError(f"articulated: camera_imu launches {launches}, expected {want}")
    del env
    return launches


def catalog_subphase(torch, port, rc, card):
    """13d: each catalog camera mounted on base_quadrotor_with_camera and each
    catalog lidar on base_quadrotor_with_lidar, env_with_obstacles at
    CATALOG_ENVS envs: render() (K2, or K1 for a sensor without
    segmentation) once, finite output of the table's shape; K2 on the
    capture's inputs bit-equal to its plain version, broad phase on and
    off, timed with its bound (time_mode), and K1 the same where render()
    ran it. Returns (render launches by mode, {config: K2 record}, {config:
    K1 record})."""
    from aerial_gym_simulator_tpu_torch.config.sensor_config import sensor_configs
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        build_ray_sensor_params, cast_inputs)
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    launches = {k: 0 for k in rc.LAUNCHES}
    k2, k1 = {}, {}
    for robot, kind, names in (("base_quadrotor_with_camera", "camera", CATALOG_CAMERAS),
                               ("base_quadrotor_with_lidar", "lidar", CATALOG_LIDARS)):
        env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", robot,
                                          "lee_velocity_control", num_envs=CATALOG_ENVS,
                                          seed=5)
        prefix = "cam" if kind == "camera" else "lidar"
        for name in names:
            sp = build_ray_sensor_params(getattr(sensor_configs, name)(), env.device)
            env.params = replace(env.params, **{kind: sp})
            env.reset()                                    # draws this sensor's mount
            zero_counts(rc.LAUNCHES)
            env.render()
            torch.cuda.synchronize()
            got = dict(rc.LAUNCHES)
            mode = "raycast_seg" if sp.segmentation_camera else "raycast_depth"
            want = {k: int(k == mode) for k in rc.LAUNCHES}
            pixels = env.get_obs()["depth_range_pixels"]
            if got != want or tuple(pixels.shape) != (CATALOG_ENVS, sp.height, sp.width) \
                    or not bool(torch.isfinite(pixels).all()):
                raise AssertionError(f"catalog {name}: launches {got} (expected {want}), "
                                     f"pixels {tuple(pixels.shape)}")
            for k, v in got.items():
                launches[k] += v
            args = cast_inputs(env.params, env.state, sp, getattr(env.state, prefix + "_mount_pos"),
                               getattr(env.state, prefix + "_mount_quat"))
            n_tri = env.params.scene.n_tri
            table = f"{sp.height}x{sp.width}"
            rec, _ = time_mode(torch, rc, args, n_tri, "raycast_seg", card,
                               f"catalog {name} ({table}, {sp.max_range:g} m)")
            k2[name] = dict(rec, table=table, launches=got["raycast_seg"], library_ms=None)
            if mode == "raycast_depth":
                rec, _ = time_mode(torch, rc, args, n_tri, "raycast_depth", card,
                                   f"catalog {name} ({table}, {sp.max_range:g} m)")
                k1[name] = dict(rec, table=table, launches=got["raycast_depth"], library_ms=None)
            del args
        del env
        torch.cuda.empty_cache()
    return launches, k2, k1


def articulated_phase(torch, port, rc, ac, card):
    """Phase 13: the articulated robots, their tasks, the IMU and the sensor
    catalog; each part's seconds. Returns (the ray-cast launches of its
    render() calls, the catalog's K2 and K1 records)."""
    seconds = {}
    t0 = time.perf_counter()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    busy = articulated_tasks_subphase(torch, port, card)
    if any({**rc.LAUNCHES, **ac.LAUNCHES}.values()):
        raise AssertionError(f"articulated: a kernel launched on a state-only path: "
                             f"{rc.LAUNCHES} {ac.LAUNCHES}")
    seconds["a tasks"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    solver_subphase(torch, port, card)
    seconds["b solver"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    camera_imu = imu_subphase(torch, port, rc, card)
    seconds["c imu"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    catalog, k2, k1 = catalog_subphase(torch, port, rc, card)
    seconds["d catalog"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    launches = {k: camera_imu[k] + catalog[k] for k in catalog}
    log("articulated: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f" = {sum(seconds.values()):.1f} | under the profiler: "
        + "; ".join(f"{k} {busy_text(*v)}" for k, v in busy.items()) + f" | {card}")
    return launches, k2, k1


def sliced(args, n):
    """The ray cast's inputs (pose, prims, dirs, mult, counts..., range)
    cut to their first n envs."""
    return (args[0][:n].contiguous(), args[1][:n].contiguous()) + tuple(args[2:])


def scene_mode(torch, rc, args, n_tri, name, card, tag, check_envs, face=None, env_chunk=512,
               sweep=None):
    """One ray-cast mode on a scene table: the kernel timed by CUDA events
    at the path's full width, bit-equal to the plain version (broad phase on
    and off) on the first ``check_envs`` envs (exact_check; the plain
    version timed there), and the bound at full width. ``face`` (the
    normal mode's at full width) counts the RGB mode's per-hit work;
    ``sweep`` is the table's sweep_counts, counted once for its modes.
    Returns (the record's numbers, the normal mode's face ids)."""
    check_envs = min(check_envs, args[0].shape[0])
    ms = event_ms(torch, lambda: rc.raycast(*args, n_tri=n_tri, **MODE_KW[name]), 5)
    err, plain_ms, _ = exact_check(torch, rc, sliced(args, check_envs), n_tri,
                                   f"{tag} ({check_envs} envs)", name)
    out = rc.raycast(*args, n_tri=n_tri, **MODE_KW[name])
    if name == "raycast_normals":
        face = out[3]
    hit = ("" if out[1] is None else
           f", hit share {(out[1] != rc.oracle.NO_HIT_SEGMENTATION_VAL).float().mean().item():.4f}")
    del out
    pose, prims, dirs = args[:3]
    b_ms, b_by, ops, tests = bound_ms(torch, rc, pose, prims, dirs, args[4:7], n_tri, args[7],
                                      name, face, env_chunk, sweep)
    log(f"timing {name} {tag} ({pose.shape[0]}x{tuple(dirs.shape[:-1])} rays, "
        f"{prims.shape[1]} prims{hit}): kernel {ms:.3f} ms, plain {plain_ms:.1f} ms on "
        f"{check_envs} envs | {bound_text(b_ms, b_by, ops, tests, ms)} | {card}")
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain_ms, "plain_envs": check_envs, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err, "tests_per_ray": tests,
            "library_ms": None}, face


def camera_args(rc, env, state=None):
    """The camera's ray-cast inputs exactly as render_camera builds them."""
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    st = env.state if state is None else state
    return cast_inputs(env.params, st, env.params.camera, st.cam_mount_pos, st.cam_mount_quat)


def drive(torch, rc, env, steps, step_kw=None, render=("sensors",)):
    """``steps`` of env.step (zero actions, ``step_kw`` passed on) and the
    render() calls named in ``render``, after one untimed step; the kernels'
    launches counted from zero over the timed steps only -> (ms per step,
    launches)."""
    zeros = torch.zeros((env.num_envs, env.num_robot_actions), device=env.device)
    env.step(zeros, **(step_kw or {}))
    for r in render:
        env.render(r)
    torch.cuda.synchronize()
    zero_counts(rc.LAUNCHES)
    t0 = time.perf_counter()
    for _ in range(steps):
        env.step(zeros, **(step_kw or {}))
        for r in render:
            env.render(r)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3, dict(rc.LAUNCHES)


def want_launches(rc, got, **want):
    """Fail unless the path launched exactly ``want`` (the other modes 0)."""
    full = {k: want.get(k, 0) for k in rc.LAUNCHES}
    if got != full:
        raise AssertionError(f"launches {got}, expected {full}")


def forest_subphase(torch, port, rc, card):
    """14a: forest_env with the camera quad at SCENE_ENVS envs: env.step +
    render() (K2) for SCENE_STEPS steps; K2 and K1 on the capture's inputs
    timed at full width, bit-equal to the plain version on 64 envs."""
    env = port.SimBuilder().build_env("base_sim", "forest_env", "base_quadrotor_with_camera",
                                      "lee_velocity_control", num_envs=SCENE_ENVS, seed=0)
    sc = env.params.scene
    ms, launches = drive(torch, rc, env, SCENE_STEPS)
    want_launches(rc, launches, raycast_seg=SCENE_STEPS)
    obs = env.get_obs()
    if not bool(torch.isfinite(obs["depth_range_pixels"]).all()):
        raise AssertionError("forest: non-finite depth")
    log(f"scenes: forest_env + base_quadrotor_with_camera, {SCENE_ENVS} envs, {sc.num_env_prims} "
        f"prims/env (box {sc.n_box}, cylinder {sc.n_cyl}, sphere {sc.n_sph}), {SCENE_STEPS} "
        f"steps of env.step + render(): {ms:.2f} ms/step, "
        f"{SCENE_ENVS / ms * 1e3:.1f} env-steps/s, launches {launches} | {card}")
    args = camera_args(rc, env)
    sweep = sweep_counts(torch, rc, args[0], args[1], args[2], args[4:7], args[7])
    recs = {}
    for name in ("raycast_seg", "raycast_depth"):
        recs[name], _ = scene_mode(torch, rc, args, sc.n_tri, name, card, "forest", 64,
                                   sweep=sweep)
        recs[name]["launches"] = launches[name]
    del args, env
    torch.cuda.empty_cache()
    return launches, recs


def dynamic_subphase(torch, port, rc, card):
    """14b: dynamic_env with the camera quad at SCENE_ENVS envs, every slot
    given DYNAMIC_TWIST by env actions: DYNAMIC_STEPS steps of env.step +
    render() (K2); the obstacles in the arena moved by steps x substeps x
    dt x v within 1e-4 m; one step from the reached state on the card and on
    the CPU within tests/test_torch_dynamics.py's bars; K2 and K1 on the
    moved table bit-equal to the plain version on 64 envs, K2 timed."""
    from aerial_gym_simulator_tpu_torch.envs.scene import apply_env_actions
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim.convert import (
        params_from_numpy, record_to_numpy, state_from_numpy)
    env = port.SimBuilder().build_env("base_sim", "dynamic_env", "base_quadrotor_with_camera",
                                      "lee_velocity_control", num_envs=SCENE_ENVS, seed=1)
    p, n, dev = env.params, SCENE_ENVS, env.device
    A = p.scene.num_assets
    v = torch.tensor(DYNAMIC_TWIST, device=dev)
    twist = v.expand(n, A, 6)
    p0 = env.state.obstacle_pos.clone()
    ms, launches = drive(torch, rc, env, DYNAMIC_STEPS, {"env_actions": twist})
    want_launches(rc, launches, raycast_seg=DYNAMIC_STEPS)
    steps = DYNAMIC_STEPS + 1                          # drive's untimed step included
    moved = env.state.obstacle_pos - p0
    expect = steps * p.env.substep_mean * p.dt * v[:3]
    arena = p0[..., 0] > -500.0                        # culled slots sit at -1000
    err = (moved - expect).abs().amax(dim=-1)[arena].max().item()
    log(f"scenes: dynamic_env + base_quadrotor_with_camera, {n} envs, {A} moving obstacles, "
        f"{DYNAMIC_STEPS} steps of env.step(env_actions) + render(): {ms:.2f} ms/step, "
        f"{n / ms * 1e3:.1f} env-steps/s, launches {launches}; obstacle travel against "
        f"{steps} x {p.env.substep_mean} x dt x v: max error {err:.3g} m over "
        f"{int(arena.sum())} obstacles in the arena (bar 1e-4) | {card}")
    if not err <= 1e-4:
        raise AssertionError(f"dynamic: obstacles moved {err} m off steps x substeps x dt x v")
    # one step on the card and on the CPU from the same carried-across state
    act = torch.rand((n, 4), generator=torch.Generator(device=dev).manual_seed(3),
                     device=dev) - 0.5
    st = apply_env_actions(p, env.state, twist)
    card_out = dynamics.env_step(p, st, act)
    cpu_out = dynamics.env_step(params_from_numpy(record_to_numpy(p), "cpu"),
                                state_from_numpy(record_to_numpy(st), "cpu"), act.cpu())
    tol = {"pos": 1e-4, "quat": 1e-4, "linvel": 1e-4, "angvel": 5e-3,
           "motor_thrust": 5e-3, "obstacle_pos": 1e-5, "obstacle_quat": 1e-5}
    errs = {f: (getattr(card_out, f).cpu() - getattr(cpu_out, f)).abs().max().item()
            for f in tol}
    log(f"scenes: dynamic one step card against CPU from a carried-across state: "
        + ", ".join(f"{k} {v:.3g} (bar {tol[k]:g})" for k, v in errs.items()) + f" | {card}")
    bad = [k for k in tol if not errs[k] <= tol[k]]
    if bad:
        raise AssertionError(f"dynamic: card and CPU steps differ in {bad}: {errs}")
    args = camera_args(rc, env)
    sweep = sweep_counts(torch, rc, args[0], args[1], args[2], args[4:7], args[7])
    recs = {}
    for name in ("raycast_seg", "raycast_depth"):
        recs[name], _ = scene_mode(torch, rc, args, p.scene.n_tri, name, card, "dynamic", 64,
                                   sweep=sweep)
        recs[name]["launches"] = launches[name]
    del args, env, card_out, cpu_out, st
    torch.cuda.empty_cache()
    return launches, recs


def stereo_subphase(torch, port, rc, card):
    """14c: base_quadrotor_with_stereo_camera in env_with_obstacles at
    STEREO_ENVS envs (270x480 per eye): env.step + render() (left K2, right
    K1); each eye bit-equal to the plain version on 16 envs, the capture
    equal to the range-limited max of the two eyes, each eye timed at full
    width. Then the twin-camera robot (two fixed cameras and the lidar) at
    TWIN_ENVS envs: render() (K2 three times), each camera slice equal to
    the single-sensor render bit for bit."""
    from aerial_gym_simulator_tpu_torch.config.robot_config import catalog
    from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
        BaseDepthCameraConfig)
    from aerial_gym_simulator_tpu_torch.registry.registries import robot_registry
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        apply_range_limits, render, right_eye_origin, sensor_world_pose)
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_stereo_camera", "lee_velocity_control",
                                      num_envs=STEREO_ENVS, seed=2)
    sp, sc, st = env.params.camera, env.params.scene, None
    ms, launches = drive(torch, rc, env, STEREO_STEPS)
    want_launches(rc, launches, raycast_seg=STEREO_STEPS, raycast_depth=STEREO_STEPS)
    capture_ms = wall_ms(torch, lambda: env.render())
    st = env.state
    left = camera_args(rc, env)
    pos_w, quat_w = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    right = (rc.pack_pose(right_eye_origin(sp, pos_w, quat_w), quat_w),) + left[1:]
    d_l, _ = rc.raycast(*left, n_tri=sc.n_tri)
    d_r, _ = rc.raycast(*right, n_tri=sc.n_tri, want_seg=False)
    fused = apply_range_limits(sp, torch.maximum(d_l, d_r).reshape(env.get_obs()[
        "depth_range_pixels"].shape)) / sp.max_range
    env.render()
    same = torch.equal(fused, env.get_obs()["depth_range_pixels"])
    log(f"scenes: stereo base_quadrotor_with_stereo_camera, {STEREO_ENVS} envs x 2 eyes x "
        f"{sp.height}x{sp.width}: {ms:.2f} ms/step (env.step + render()), {capture_ms:.2f} ms "
        f"per capture, launches {launches}; capture equal to the max of the two eyes {same} "
        f"| {card}")
    if not same:
        raise AssertionError("stereo: the capture is not the max of the two eyes")
    del d_l, d_r, fused
    recs = {}
    recs["left"], _ = scene_mode(torch, rc, left, sc.n_tri, "raycast_seg", card,
                                 "stereo left eye", 16)
    recs["right"], _ = scene_mode(torch, rc, right, sc.n_tri, "raycast_depth", card,
                                  "stereo right eye", 16)
    recs["left"]["launches"] = launches["raycast_seg"]
    recs["right"]["launches"] = launches["raycast_depth"]
    recs["capture_ms"] = capture_ms
    del left, right, env
    torch.cuda.empty_cache()

    def twin():
        cfg = catalog.base_quadrotor()
        cfg.name = "twin_camera_quad"
        cfg.sensor_config.enable_camera = True
        cfg.sensor_config.enable_lidar = True
        cam = BaseDepthCameraConfig()
        cam.num_sensors = 2
        cam.randomize_placement = False
        cfg.sensor_config.camera_config = cam
        return cfg

    robot_registry.register("twin_camera_quad", twin)
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", "twin_camera_quad",
                                      "lee_velocity_control", num_envs=TWIN_ENVS, seed=3)
    ms, twin_launches = drive(torch, rc, env, 3)
    want_launches(rc, twin_launches, raycast_seg=3 * 3)
    obs, st, sp = env.get_obs(), env.state, env.params.camera
    frames = obs["depth_range_pixels"]
    single = replace(sp, num_sensors=1)
    equal = [torch.equal(frames[:, k], render(env.params, st, single, st.cam_mount_pos[:, k],
                                              st.cam_mount_quat[:, k])[0]) for k in range(2)]
    log(f"scenes: twin cameras + lidar, {TWIN_ENVS} envs: {ms:.2f} ms/step (env.step + "
        f"render()), camera frames {tuple(frames.shape)}, lidar "
        f"{tuple(obs['lidar_range_pixels'].shape)}, launches {twin_launches}; each camera "
        f"slice equal to the single-sensor render {equal} | {card}")
    if tuple(frames.shape) != (TWIN_ENVS, 2, sp.height, sp.width) or not all(equal):
        raise AssertionError("twin cameras: a slice differs from the single-sensor render")
    del env, obs, frames
    torch.cuda.empty_cache()
    launches["raycast_seg"] += twin_launches["raycast_seg"]
    return launches, twin_launches, recs


def write_icosphere_stl(path, subdiv, radius):
    """A subdivided icosahedron as a binary STL: 20 x 4^subdiv faces."""
    import struct
    import numpy as np
    t = (1.0 + math.sqrt(5.0)) / 2.0
    v = np.array([[-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0], [0, -1, t], [0, 1, t],
                  [0, -1, -t], [0, 1, -t], [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]])
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = [[0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11], [1, 5, 9], [5, 11, 4],
         [11, 10, 2], [10, 7, 6], [7, 1, 8], [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8],
         [3, 8, 9], [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]]
    for _ in range(subdiv):
        mid, verts = {}, list(v)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in mid:
                m = verts[a] + verts[b]
                mid[key] = len(verts)
                verts.append(m / np.linalg.norm(m))
            return mid[key]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        v, f = np.asarray(verts), nf
    with open(path, "wb") as fh:
        fh.write(b"\0" * 80 + struct.pack("<I", len(f)))
        for tri in f:
            fh.write(struct.pack("<3f", 0, 0, 0))
            for vi in tri:
                fh.write(struct.pack("<3f", *(v[vi] * radius)))
            fh.write(struct.pack("<H", 0))
    return len(f)


def mesh_urdf(stl_path):
    return (f'<?xml version="1.0"?><robot name="mesh_blob"><link name="base_link"><inertial>'
            f'<mass value="1.0"/><inertia ixx="0.1" ixy="0" ixz="0" iyy="0.1" iyz="0" '
            f'izz="0.1"/></inertial><collision><origin xyz="0 0 0" rpy="0 0 0"/><geometry>'
            f'<mesh filename="{stl_path}"/></geometry></collision></link></robot>')


def mesh_subphase(torch, port, rc, card, work):
    """14d: a subdivision-4 icosphere STL (5,120 faces), decimated to the
    2,048 budget, as two keep_in_env assets of env_with_obstacles built with
    max_prims=2048 at MESH_ENVS envs with the camera quad: env.step +
    render() (K2), render("rgb") (K4 + K2), the normal/face-id capture (K3)
    and the depth-only capture (K1) each step; K1-K4 timed at full width,
    bit-equal to the plain version on MESH_CHECK_ENVS envs (broad phase on and off); the
    collision SDF 0.1 m outside the sphere within the tessellation's error.
    Then the forest's and the obstacle env's procedural URDFs as a folder of
    LOADER_FILES files: the native batch loader against the Python parser,
    models equal, both timed."""
    import xml.etree.ElementTree as ET
    import numpy as np
    from aerial_gym_simulator_tpu_torch.assets import native_loader, urdf
    from aerial_gym_simulator_tpu_torch.config.asset_config import env_object_config as eoc
    from aerial_gym_simulator_tpu_torch.config.env_config.obstacle_envs import (
        EnvWithObstaclesConfig, ForestEnvConfig)
    from aerial_gym_simulator_tpu_torch.envs.collision import scene_sdf_point
    from aerial_gym_simulator_tpu_torch.envs.scene import build_scene_params
    from aerial_gym_simulator_tpu_torch.registry.registries import (
        controller_registry, robot_registry, sim_config_registry)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        render_camera, render_normal_faceid_camera)
    from aerial_gym_simulator_tpu_torch.sim import sim_builder
    from aerial_gym_simulator_tpu_torch.sim.env_manager import EnvManager
    from aerial_gym_simulator_tpu_torch.sim.params import build_sim_params
    from aerial_gym_simulator_tpu_torch.sim.structs import replace
    stl = str(work / "icosphere4.stl")
    faces = write_icosphere_stl(stl, MESH_SUBDIV, MESH_RADIUS)
    asset = eoc.AssetTypeConfig(name="user_mesh_blobs", num_assets=2, urdf_variants=[
        mesh_urdf(stl)], min_state_ratio=eoc._ratio(0.35, 0.2, 0.3),
        max_state_ratio=eoc._ratio(0.85, 0.8, 0.7), keep_in_env=True, semantic_id=42)
    env_cfg = EnvWithObstaclesConfig()
    env_cfg.asset_types = list(env_cfg.asset_types) + [asset]
    env_cfg.__post_init__()
    dev = sim_builder.resolve_device(None)
    t0 = time.perf_counter()
    scene = build_scene_params(env_cfg, MESH_ENVS, dev, max_prims=MESH_BUDGET)
    build_s = time.perf_counter() - t0
    per_mesh = int((scene.prim_kind[-1] == 3).sum())
    sim_cfg, robot_cfg = sim_config_registry.make("base_sim"), robot_registry.make(
        "base_quadrotor_with_camera")
    ctrl_cfg = controller_registry.make("lee_velocity_control")
    params = build_sim_params(sim_cfg, env_cfg, robot_cfg, ctrl_cfg, dev, num_envs=MESH_ENVS,
                              scene=scene)
    env = EnvManager(params, seed=4, sim_config=sim_cfg, env_config=env_cfg,
                     robot_config=robot_cfg, controller_config=ctrl_cfg)
    table_gb = MESH_ENVS * scene.num_env_prims * 16 * 4 / 1e9
    log(f"scenes: mesh {faces} faces decimated to {per_mesh} triangles per asset, 2 assets in "
        f"env_with_obstacles, max_prims {MESH_BUDGET}: {scene.num_env_prims} prims/env (box "
        f"{scene.n_box}, cylinder {scene.n_cyl}, sphere {scene.n_sph}, triangle {scene.n_tri}), "
        f"world table {table_gb:.3f} GB at {MESH_ENVS} envs, scene build {build_s:.2f} s | {card}")
    if not (faces == 20 * 4 ** MESH_SUBDIV and MESH_BUDGET // 2 < per_mesh <= MESH_BUDGET
            and scene.n_tri == 2 * per_mesh):
        raise AssertionError("mesh: the STL did not compile to the budgeted triangles")

    ms, launches = drive(torch, rc, env, MESH_STEPS, render=("sensors", "rgb"))
    for _ in range(MESH_STEPS):                        # the other two captures, counted too
        render_normal_faceid_camera(env.params, env.state)
        render_camera(env.params, env.state, want_seg=False)
    torch.cuda.synchronize()
    launches = dict(rc.LAUNCHES)
    want_launches(rc, launches, raycast_seg=2 * MESH_STEPS, raycast_rgb=MESH_STEPS,
                  raycast_normals=MESH_STEPS, raycast_depth=MESH_STEPS)
    obs = env.get_obs()
    hit_mesh = (obs["segmentation_pixels"] == 42).float().mean().item()
    log(f"scenes: mesh env + base_quadrotor_with_camera, {MESH_ENVS} envs: {ms:.2f} ms/step "
        f"(env.step + render() + render('rgb')), launches {launches}, share of pixels on the "
        f"mesh {hit_mesh:.4f} | {card}")
    if not (bool(torch.isfinite(obs["depth_range_pixels"]).all()) and hit_mesh > 0.0):
        raise AssertionError("mesh: no pixel saw the mesh, or a non-finite depth")
    args = camera_args(rc, env)
    sweep = sweep_counts(torch, rc, args[0], args[1], args[2], args[4:7], args[7], env_chunk=64)
    recs, face = {}, None
    for name in ("raycast_depth", "raycast_seg", "raycast_normals", "raycast_rgb"):
        recs[name], face = scene_mode(torch, rc, args, scene.n_tri, name, card, "mesh",
                                      MESH_CHECK_ENVS, face, sweep=sweep)
        recs[name]["launches"] = launches[name]
    del args, face

    # the collision SDF sees the mesh: each env's first mesh slot alone,
    # a point 0.1 m outside the sphere along a fixed direction
    st = env.state
    slot = int(torch.nonzero(scene.semantic_id == 42)[0, 0])
    parked = torch.full_like(st.obstacle_pos, -1000.0)
    parked[:, slot] = st.obstacle_pos[:, slot]
    lone = replace(st, obstacle_pos=parked)
    d = torch.tensor([0.48, -0.6, 0.64], device=st.pos.device)
    point = st.obstacle_pos[:, slot] + (MESH_RADIUS + 0.1) * d / d.norm()
    dist = scene_sdf_point(env.params, lone, point)
    # the decimated mesh lies between its nearest face plane and its
    # farthest vertex from the centre
    kind = scene.prim_kind[-1]
    tri = kind == 3
    size, v0 = scene.prim_size[-1][tri].double(), scene.prim_pos[-1][tri].double()
    rot = scene.prim_rot[-1][tri].double()
    verts = torch.cat([v0, v0 + rot[:, :, 0] * size[:, :1],
                       v0 + rot[:, :, 0] * size[:, 1:2] + rot[:, :, 1] * size[:, 2:3]])
    r_out = verts.norm(dim=-1).max().item()
    r_in = (rot[:, :, 2] * v0).sum(-1).abs().min().item()
    lo, hi = MESH_RADIUS + 0.1 - r_out - 1e-4, MESH_RADIUS + 0.1 - r_in + 1e-4
    d_min, d_max = dist.min().item(), dist.max().item()
    log(f"scenes: mesh collision SDF 0.1 m outside the sphere, {MESH_ENVS} envs: distance "
        f"{d_min:.5f}-{d_max:.5f} m, the tessellation allows {lo:.5f}-{hi:.5f} m | {card}")
    if not (lo <= d_min and d_max <= hi):
        raise AssertionError(f"mesh: SDF {d_min}-{d_max} outside [{lo}, {hi}]")
    del env, params, scene, st, lone, parked
    torch.cuda.empty_cache()

    # the native batch loader against the Python parser on a folder of
    # the forest's and the obstacle env's procedural URDFs
    folder = work / "urdfs"
    folder.mkdir()
    texts = [t for cfg in (ForestEnvConfig(), EnvWithObstaclesConfig())
             for at in cfg.asset_types for t in at.urdf_variants]
    files = []
    for k in range(LOADER_FILES):
        path = folder / f"asset_{k:04d}.urdf"
        path.write_text(texts[k % len(texts)])
        files.append(str(path))
    native_loader.load_urdf_string_native(texts[0])          # the build, untimed
    t0 = time.perf_counter()
    native = native_loader.load_urdf_batch(files)
    native_s = time.perf_counter() - t0
    if native is None:
        raise AssertionError("loaders: the native compiler declined a procedural URDF")
    t0 = time.perf_counter()
    python = [urdf._parse_urdf_tree(ET.parse(f).getroot(), f) for f in files]
    python_s = time.perf_counter() - t0
    worst = 0.0
    for a, b in zip(native, python):
        if len(a.primitives) != len(b.primitives) or any(
                pa.kind != pb.kind or pa.semantic_id != pb.semantic_id
                for pa, pb in zip(a.primitives, b.primitives)):
            raise AssertionError(f"loaders: {b.path} differs in its primitives")
        worst = max([worst, abs(a.mass - b.mass), abs(a.bound_radius - b.bound_radius),
                     float(np.abs(a.com - b.com).max()), float(np.abs(a.inertia - b.inertia).max())]
                    + [float(np.abs(x - y).max()) for pa, pb in zip(a.primitives, b.primitives)
                       for x, y in ((pa.size, pb.size), (pa.xyz, pb.xyz), (pa.rot, pb.rot))])
    log(f"scenes: loaders, {LOADER_FILES} procedural URDFs ({len(texts)} distinct, the forest's "
        f"and the obstacle env's): native batch {native_s * 1e3:.1f} ms, Python parser "
        f"{python_s * 1e3:.1f} ms ({python_s / native_s:.1f}x), models equal, largest difference "
        f"{worst:.3g} (f32 rounding; bar 1e-4) | host CPU, {card}")
    if not worst <= 1e-4:
        raise AssertionError(f"loaders: native and Python models differ by {worst}")
    return launches, recs, {"native_ms": native_s * 1e3, "python_ms": python_s * 1e3,
                            "files": LOADER_FILES}


def scenes_phase(torch, port, rc, card):
    """Phase 14: the forest and dynamic scenes, stereo and multi-sensor
    capture, the mesh scene and the native loader; each part's seconds.
    Returns (the ray-cast launches of the paths by mode, {mode: {table:
    record}})."""
    seconds, launches = {}, {k: 0 for k in rc.LAUNCHES}
    tables = {k: {} for k in rc.LAUNCHES}

    def add(got, recs, tag):
        for k, v in got.items():
            launches[k] += v
        for k, rec in recs.items():
            tables[k][tag] = rec

    t0 = time.perf_counter()
    got, recs = forest_subphase(torch, port, rc, card)
    add(got, recs, f"at_{SCENE_ENVS}x{135 * 240}_forest")
    seconds["a forest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, recs = dynamic_subphase(torch, port, rc, card)
    add(got, recs, f"at_{SCENE_ENVS}x{135 * 240}_dynamic")
    seconds["b dynamic"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got, twin, recs = stereo_subphase(torch, port, rc, card)
    add(got, {}, "")
    tables["raycast_seg"][f"at_{STEREO_ENVS}x{270 * 480}_stereo_left"] = dict(
        recs["left"], capture_ms=recs["capture_ms"], twin_camera_launches=twin["raycast_seg"])
    tables["raycast_depth"][f"at_{STEREO_ENVS}x{270 * 480}_stereo_right"] = recs["right"]
    seconds["c stereo"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        got, recs, loaders = mesh_subphase(torch, port, rc, card, Path(work))
    add(got, recs, f"at_{MESH_ENVS}x{135 * 240}_mesh")
    tables["raycast_depth"][f"at_{MESH_ENVS}x{135 * 240}_mesh"]["loaders"] = loaders
    seconds["d mesh"] = time.perf_counter() - t0
    log("scenes: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f" = {sum(seconds.values()):.1f}, launches {launches} | {card}")
    return launches, tables


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


def scene_slice(sc, n, device):
    """The ray cast's view of a scene (its env_prim_* tables and kind
    counts) for the first n envs, on ``device``."""
    from types import SimpleNamespace
    fields = ("env_prim_kind", "env_prim_size", "env_prim_pos", "env_prim_rot",
              "env_prim_semantic", "env_prim_slot")
    return SimpleNamespace(**{k: getattr(sc, k)[:n].to(device) for k in fields},
                           n_box=sc.n_box, n_cyl=sc.n_cyl, n_sph=sc.n_sph, n_tri=sc.n_tri)


def diff_render_subphase(torch, port, rc, card):
    """15a: ops/raycast_diff on the obstacle env's camera at DIFF_ENVS envs
    with the full 135x240 grid: "kernel" bit-equal to raycast_reference,
    edge flips against "oracle" on at most DIFF_EDGE_SHARE of the rays and
    the rest within tests/test_torch_raycast.py's depth bar (2e-3 m); the
    pose gradients on the card against the CPU's on the first
    DIFF_GRAD_ENVS envs, within 1e-3 of the largest; DIFF_TIMED_STEPS steps
    of tests/test_raycast_diff.py's inverse rendering at this width (each
    step's K1 forward and oracle backward timed, peak memory, the device's
    idle share; the loss must fall); K1 on this table timed with its
    bound. Then the recipe itself on its own scene and 8x128 table (the
    2-env obstacle env, seed 7, built on the CPU and carried to the card):
    at most DIFF_STEPS Adam steps, the loss below 5% of its start (the run
    ends at the first step below it). At the full table the depth loss keeps silhouette pixels that switch between an
    obstacle and the wall or a miss, which no gradient moves, so the 5% bar
    is held where the recipe set it. Returns (K1 launches of the two
    descents, K1's record on this table)."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.ops.raycast_diff import raycast_depth_diff
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import sensor_world_pose
    from aerial_gym_simulator_tpu_torch.sim.convert import (
        params_from_numpy, record_to_numpy, state_from_numpy)

    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=DIFF_ENVS, seed=0)
    env.reset()
    sc, sp, st = env.params.scene, env.params.camera, env.state
    origin, quat = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    dirs, mr, oq = sp.dirs, sp.max_range, st.obstacle_quat
    H, W = dirs.shape[:2]
    render = lambda op, mode="kernel": raycast_depth_diff(sc, op, oq, origin, quat, dirs, mr,
                                                          mode)
    args = (rc.pack_pose(origin, quat), rc.pack_prims_world(sc, st.obstacle_pos, oq), dirs,
            torch.ones(dirs.shape[:-1], device=dirs.device), sc.n_box, sc.n_cyl, sc.n_sph, mr)
    with torch.no_grad():
        target = render(st.obstacle_pos)
        ref, _ = rc.raycast_reference(*args, want_seg=False, n_tri=sc.n_tri)
        exact = torch.equal(target, ref)
        gap = (target - render(st.obstacle_pos, "oracle")).abs()
        # a ray grazing a silhouette edge can hit in one and miss in the
        # other (the kernel's world-frame tables against the oracle's asset
        # frames): such rays are held to the seg bar of the kernel tests
        edge = gap > 2e-3
        gap_max, gap_rays, edge_rays = (gap[~edge].max().item(), int((gap > 1e-4).sum()),
                                        int(edge.sum()))
    del ref, gap, edge
    hit = target < rc.oracle.NO_HIT_RAY_VAL
    line = (f"differentiable: raycast_depth_diff at {DIFF_ENVS}x{H}x{W} rays, "
            f"{sc.num_env_prims} prims, hit share {hit.float().mean().item():.4f}: kernel mode "
            f"{'bit-equal to' if exact else 'DIFFERS from'} raycast_reference; against the "
            f"oracle {edge_rays} rays apart by more than 2e-3 m (edge flips; at most "
            f"{DIFF_EDGE_SHARE:.1%} allowed), the rest within {gap_max:.3g} m, {gap_rays} rays "
            f"above 1e-4")
    log(line)
    if not (exact and edge_rays <= DIFF_EDGE_SHARE * H * W * DIFF_ENVS):
        raise AssertionError(line)

    # the pose gradients on the card and on the CPU from the same inputs
    t_part = time.perf_counter()
    w = torch.sin(torch.arange(H * W, dtype=torch.float32) * 0.37)
    grads = {}
    for name, device in (("card", dirs.device), ("cpu", torch.device("cpu"))):
        n = DIFF_GRAD_ENVS
        poses = [x[:n].detach().to(device).requires_grad_(True)
                 for x in (st.obstacle_pos, oq, origin, quat)]
        t = raycast_depth_diff(scene_slice(sc, n, device), *poses, dirs.to(device), mr, "kernel")
        torch.sum(torch.where(t < rc.oracle.NO_HIT_RAY_VAL, t, torch.zeros_like(t))
                  * w.to(device)).backward()
        grads[name] = [p.grad.cpu() for p in poses]
    errs = []
    for name, a, b in zip(("obstacle_pos", "obstacle_quat", "origin", "quat"), grads["card"],
                          grads["cpu"]):
        scale = b.abs().max().item()
        errs.append((a - b).abs().max().item() / max(scale, 1e-30))
        if not (torch.isfinite(a).all() and scale > 0.0 and errs[-1] <= 1e-3):
            raise AssertionError(f"differentiable: d/d {name} on the card against the CPU: "
                                 f"{errs[-1]:.3g} of the largest {scale:.4g}")
    log(f"differentiable: pose gradients at {DIFF_GRAD_ENVS}x{H}x{W} rays, card against CPU: "
        "obstacle_pos, obstacle_quat, origin, quat within "
        + ", ".join(f"{e:.3g}" for e in errs)
        + f" of the largest ({time.perf_counter() - t_part:.1f} s)")

    # the descent at full width: timed steps of tests/test_raycast_diff.py's recipe
    launches, timing = descend(torch, rc, render, st.obstacle_pos, DIFF_TIMED_STEPS, card,
                               f"{DIFF_ENVS}x{H}x{W}")
    rec, _ = time_mode(torch, rc, args, sc.n_tri, "raycast_depth", card, "differentiable")
    rec.update(library_ms=None, launches=launches["raycast_depth"], **timing,
               oracle_gap_m=gap_max, oracle_rays_above_1e_4=gap_rays, oracle_edge_rays=edge_rays)
    del env, target, args
    torch.cuda.empty_cache()

    # the recipe itself, on the 2-env obstacle scene (seed 7, built on the
    # CPU and carried to the card) and its 8x128 ray table
    cpu_env = port.SimBuilder().build_env("base_sim", "env_with_obstacles", "base_quadrotor",
                                          "lee_velocity_control", num_envs=2, seed=7,
                                          device="cpu")
    cpu_env.reset()
    dev = dirs.device
    sc2 = params_from_numpy(record_to_numpy(cpu_env.params), dev).scene
    st2 = state_from_numpy(record_to_numpy(cpu_env.state), dev)
    ys, xs = np.meshgrid(np.linspace(-0.4, 0.4, 8), np.linspace(-0.6, 0.6, 128), indexing="ij")
    table = np.stack([xs, ys, np.ones_like(xs)], axis=-1).reshape(-1, 3)
    table = torch.from_numpy((table / np.linalg.norm(table, axis=-1, keepdims=True))
                             .astype(np.float32)).to(dev)
    got, recipe = descend(torch, rc, lambda op: raycast_depth_diff(
        sc2, op, st2.obstacle_quat, st2.pos, st2.quat, table, 10.0, "kernel"), st2.obstacle_pos,
        DIFF_STEPS, card, "2x1024 (tests/test_raycast_diff.py's table)", stop_below=0.05)
    if not recipe["loss_ratio"] < 0.05:
        raise AssertionError(f"inverse rendering stalled: {recipe}")
    launches["raycast_depth"] += got["raycast_depth"]
    rec.update(launches=launches["raycast_depth"], recipe_at_2x1024=recipe)
    return launches, rec


def descend(torch, rc, render, truth, steps, card, tag, stop_below=None):
    """tests/test_raycast_diff.py's inverse rendering: Adam (DIFF_LR) on
    obstacle positions perturbed by DIFF_PERTURB m (numpy seed 0) toward
    the depth image of ``truth``, for ``steps`` steps, or until a step's
    loss is below ``stop_below`` of the start's when that is given, each
    step's K1 forward and oracle backward timed by CUDA events; the loss
    must fall. -> (the K1 launches of the steps, {loss_ratio, steps,
    step_ms, forward_ms, oracle_backward_ms, peak_gb, idle_share})."""
    import numpy as np
    with torch.no_grad():
        target = render(truth)
    hit = target < rc.oracle.NO_HIT_RAY_VAL
    zero = torch.zeros_like(target)
    rs = np.random.RandomState(0)
    noise = torch.from_numpy(rs.standard_normal(tuple(truth.shape)).astype(np.float32))
    op = (truth + DIFF_PERTURB * noise.to(truth.device)).requires_grad_(True)
    opt = torch.optim.Adam([op], lr=DIFF_LR)
    with torch.no_grad():
        l0 = torch.mean(torch.where(hit, (render(op) - target) ** 2, zero)).item()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]

    def step():
        opt.zero_grad(set_to_none=True)
        ev[0].record()
        t = render(op)
        ev[1].record()
        loss = torch.mean(torch.where(hit, (t - target) ** 2, zero))
        loss.backward()
        ev[2].record()
        opt.step()
        return loss.detach()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts(rc.LAUNCHES)
    fwd_ms, bwd_ms, t0 = [], [], time.perf_counter()
    for _ in range(steps):
        loss = step()
        torch.cuda.synchronize()
        fwd_ms.append(ev[0].elapsed_time(ev[1]))
        bwd_ms.append(ev[1].elapsed_time(ev[2]))
        if stop_below is not None and loss.item() < stop_below * l0:
            break
    taken = len(fwd_ms)
    wall = (time.perf_counter() - t0) / taken * 1e3
    launches = dict(rc.LAUNCHES)
    want_launches(rc, launches, raycast_depth=taken)
    peak = torch.cuda.max_memory_allocated() / 1e9
    final = loss.item()
    busy = device_busy(torch, step, 1)              # ~65k launches a step
    med = lambda x: sorted(x)[len(x) // 2]
    out = {"loss_ratio": final / l0, "steps": taken, "step_ms": wall, "forward_ms": med(fwd_ms),
           "oracle_backward_ms": med(bwd_ms), "peak_gb": peak,
           "idle_share": 1.0 - busy[1] / busy[0]}
    log(f"differentiable: inverse rendering at {tag}, {taken} Adam steps of at most {steps} "
        f"(lr {DIFF_LR}, obstacle positions perturbed {DIFF_PERTURB} m): loss {l0:.4g} -> {final:.4g} "
        f"({final / l0:.3%} of its start); per step {wall:.1f} ms, K1 forward median "
        f"{out['forward_ms']:.3f} ms, oracle backward median {out['oracle_backward_ms']:.1f} ms "
        f"(with the loss's elementwise ops), peak memory {peak:.2f} GB, {busy_text(*busy)} | "
        f"{card}")
    if not (math.isfinite(final) and final < l0):
        raise AssertionError(f"inverse rendering at {tag} did not descend: {l0} -> {final}")
    return launches, out


def rollout_grad_subphase(torch, port, card):
    """15b: d/d tau and d/d drag of tests/test_differentiable.py's rollout
    (empty_env, lee_velocity_control, 2 envs, seed 3, ROLLOUT_STEPS steps of
    its excitation) on the card against the CPU from the same state, within
    1e-3 relative."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    from aerial_gym_simulator_tpu_torch.sim.convert import (
        params_from_numpy, record_to_numpy, state_from_numpy)
    from aerial_gym_simulator_tpu_torch.sim.structs import replace

    env = port.SimBuilder().build_env("base_sim", "empty_env", "base_quadrotor",
                                      "lee_velocity_control", num_envs=2, seed=3)
    env.reset()
    t = np.arange(ROLLOUT_STEPS)[:, None, None] * 0.01
    ph = np.arange(2)[None, :, None] * 0.9
    acts = np.concatenate([np.sin(6 * t + ph), np.sin(9 * t + 1.3 + ph), np.sin(4 * t + 2.1 + ph),
                           0.3 * np.sin(3 * t + ph)], axis=2).astype(np.float32)
    copies = {"card": (env.params, env.state),
              "cpu": (params_from_numpy(record_to_numpy(env.params), "cpu"),
                      state_from_numpy(record_to_numpy(env.state), "cpu"))}
    grads = {}
    for name, (p0, s0) in copies.items():
        dev = s0.device
        tau = torch.tensor(0.08, device=dev, requires_grad=True)
        drag = torch.tensor([0.15, 0.12, 0.25], device=dev, requires_grad=True)
        p = replace(p0, robot=replace(p0.robot, drag_lin_linear=drag))
        st = replace(s0, motor_tau_inc=tau.expand_as(s0.motor_tau_inc),
                     motor_tau_dec=tau.expand_as(s0.motor_tau_dec))
        traj = []
        for a in torch.from_numpy(acts).to(dev):
            st = dynamics.env_step(p, st, a)
            traj.append(torch.cat([st.pos, st.linvel], dim=-1))
        traj = torch.stack(traj)
        wts = torch.sin(torch.arange(traj.numel(), dtype=torch.float32, device=dev) * 0.1)
        torch.sum(traj * wts.reshape(traj.shape)).backward()
        grads[name] = np.concatenate([[tau.grad.item()], drag.grad.cpu().numpy()])
    rel = np.abs(grads["card"] - grads["cpu"]) / np.abs(grads["cpu"])
    line = (f"differentiable: {ROLLOUT_STEPS}-step rollout gradients (2 envs), card "
            f"d/d tau {grads['card'][0]:.6g}, d/d drag {np.array2string(grads['card'][1:], precision=6)}"
            f"; against the CPU's, relative {np.array2string(rel, precision=3)}")
    log(line)
    if not (np.isfinite(grads["card"]).all() and rel.max() <= 1e-3):
        raise AssertionError(line)


def bptt_subphase(torch, port, card):
    """15c: rl.bptt at BPTTConfig's defaults (256 envs, horizon 16, lr 2e-3,
    seed 0) on position_setpoint_task for BPTT_ITERS iterations: the
    surrogate, the task reward and the best EMA finite, act bounded; s per
    iteration, one more window's forward / backward split, the device's
    idle share and peak memory; then two windows with remat=True from a
    copy of the state against remat=False: gradients within 1e-6 and the
    generator's state equal. tests/test_bptt.py's learning bar (best EMA
    above max(3, 2 x the first window's reward)) is met after about 140
    iterations, about 0.8 s each on the card (the host launches every
    op), so this depth does not hold it."""
    from aerial_gym_simulator_tpu_torch.rl.bptt import (
        BPTTConfig, BPTTTrainer, detach_carry, remat_step)

    cfg = BPTTConfig()
    task = port.task_registry.make_task("position_setpoint_task", num_envs=cfg.num_envs,
                                        seed=cfg.seed)
    trainer = BPTTTrainer(task, cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    hist = trainer.train(iters=BPTT_ITERS, log_every=2)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 1e9
    r0, best = hist[0]["task_reward"], trainer.best_ema
    a = trainer.act(trainer.obs)
    bound = a.abs().max().item()
    s_it = hist[-1]["wall_s"] / BPTT_ITERS
    log(f"differentiable: BPTT {cfg.num_envs} envs x {cfg.horizon} steps, {BPTT_ITERS} "
        f"iterations: task reward " + ", ".join(f"{m['task_reward']:.3f}" for m in hist)
        + f"; best EMA {best:.3f} (first window {r0:.3f}); {s_it:.3f} s per "
        f"iteration, peak memory {peak:.2f} GB, |act| <= {bound:.4f} | {card}")
    if not all(math.isfinite(m[k]) for m in hist for k in ("surrogate", "task_reward")):
        raise AssertionError("BPTT: non-finite surrogate or task reward")
    if hist[-1]["iter"] != BPTT_ITERS - 1 or not math.isfinite(best):
        raise AssertionError(f"BPTT: last iteration {hist[-1]['iter']}, best EMA {best}")
    if not (a.shape == (cfg.num_envs, 4) and bound <= cfg.action_scale + 1e-6):
        raise AssertionError(f"BPTT act: shape {tuple(a.shape)}, max |a| {bound}")

    raw, carry0, obs0 = trainer.step_fn, detach_carry(trainer.carry), trainer.obs
    (loss, _), fwd_ms = timed(torch, trainer.window)
    _, bwd_ms = timed(torch, loss.backward)
    ema, best_t = torch.zeros((), device=task.device), torch.full((), -math.inf,
                                                                   device=task.device)
    snap = [p.detach().clone() for p in trainer.params]
    busy = device_busy(torch, lambda: trainer.update(1, ema, best_t, snap), 1)
    log(f"differentiable: BPTT window split: forward {fwd_ms:.1f} ms, backward {bwd_ms:.1f} "
        f"ms; an update {busy_text(*busy)} | {card}")

    state0 = carry0.rng.get_state()
    runs = []
    for step_fn in (raw, remat_step(raw)):
        trainer.step_fn = step_fn
        carry0.rng.set_state(state0)
        trainer.carry, trainer.obs = carry0, obs0
        grads, dones = [], 0
        for _ in range(2):
            trainer.optimizer.zero_grad(set_to_none=True)
            loss, (carry, obs, _) = trainer.window()
            loss.backward()
            grads.append([p.grad.clone() for p in trainer.params])
            dones += int((carry.sim_steps < trainer.carry.sim_steps + cfg.horizon).sum())
            trainer.carry, trainer.obs = detach_carry(carry), obs.detach()
        runs.append((grads, carry0.rng.get_state(), trainer.carry.pos, dones))
    trainer.step_fn = raw
    (g0, s0, pos0, d0), (g1, s1, pos1, _) = runs
    err = max((a - b).abs().max().item() for ga, gb in zip(g0, g1) for a, b in zip(ga, gb))
    same = torch.equal(s0, s1) and torch.equal(pos0, pos1)
    line = (f"differentiable: BPTT remat, two windows ({d0} envs reset in them): gradients "
            f"within {err:.3g} of remat=False's, generator state and final poses "
            f"{'equal' if same else 'DIFFER'}")
    log(line)
    if not (same and err <= 1e-6):
        raise AssertionError(line)
    task.close()


def population_subphase(torch, port, card):
    """15d: rl.population's command line (POP_ARGS: 8 members of 1,024 envs
    x 32, log-spaced lrs, PBT every iteration, 2 iterations, --save_best):
    finite rewards of shape (8,), the aggregate env-steps/s; the saved best
    member loaded by a standalone trainer acts as the member does, bit for
    bit; member 0 of a 2-member population at the same width equals a
    standalone PPOTrainer with its seed bit for bit after 2 iterations."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.rl import population
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer

    with tempfile.TemporaryDirectory() as work:
        path = os.path.join(work, "best.ckpt")
        pop, wall = timed(torch, lambda: population.main(POP_ARGS + ["--save_best", path]))
        m = pop.last_metrics
        r = m["reward_mean"]
        best = pop.best_member()
        member = pop.members[best]
        task = port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=0)
        solo = PPOTrainer(task, dataclasses.replace(pop.cfg, num_envs=8, minibatch_size=256))
        solo.load_checkpoint(path)
        obs = member.obs[:256]
        acts_equal = torch.equal(solo.act(obs), member.act(obs))
    line = (f"differentiable: population CLI, {pop.num_seeds} members x {pop.cfg.num_envs} "
            f"envs x {pop.cfg.horizon}, {m['iter'] + 1} iterations with PBT: rewards "
            f"{np.array2string(r, precision=3)}, lrs "
            + ", ".join(f"{x.lr.item():.3g}" for x in pop.members)
            + f"; best member {best}, its checkpoint acts "
            f"{'bit-equal' if acts_equal else 'DIFFERENTLY'}; {m['env_steps_per_s']:.1f} "
            f"env-steps/s aggregate, {wall / 1e3:.1f} s wall | {card}")
    log(line)
    if not (r.shape == (8,) and np.isfinite(r).all() and acts_equal):
        raise AssertionError(line)
    del pop, solo, task
    torch.cuda.empty_cache()

    n = POP_COMPARE_ENVS
    cfg = PPOConfig(num_envs=n, horizon=32, minibatch_size=min(8192, n * 32), seed=42)
    factory = lambda s: port.task_registry.make_task("position_setpoint_task", num_envs=n,
                                                     seed=s)
    pop = population.PopulationTrainer(factory, cfg, num_seeds=2)
    pop.train(total_env_steps=2 * n * 32, log_every=1)
    solo = PPOTrainer(factory(42), cfg)
    solo.train(total_env_steps=2 * n * 32, log_every=1)
    a, b = training_snapshot(torch, pop.members[0]), training_snapshot(torch, solo)
    differ = [k for k in b if not torch.equal(a[k], b[k])]
    line = (f"differentiable: population member 0 against a standalone trainer ({n} x 32, "
            f"2 iterations): {len(b) - len(differ)} of {len(b)} tensors bit-equal"
            + (f", differing: {differ}" if differ else ""))
    log(line)
    if differ:
        raise AssertionError(line)


def differentiable_phase(torch, port, rc, card):
    """Phase 15: the differentiable ray cast and inverse rendering (K1),
    rollout gradients, BPTT and the PPO population (no kernel); each part's
    seconds. Returns (K1 launches of the inverse-rendering loop, K1's record
    on its table)."""
    seconds = {}
    t0 = time.perf_counter()
    launches, k1 = diff_render_subphase(torch, port, rc, card)
    seconds["a render"] = time.perf_counter() - t0
    zero_counts(rc.LAUNCHES)
    for tag, part in (("b rollout", rollout_grad_subphase), ("c bptt", bptt_subphase),
                      ("d population", population_subphase)):
        t0 = time.perf_counter()
        part(torch, port, card)
        seconds[tag] = time.perf_counter() - t0
    want_launches(rc, dict(rc.LAUNCHES))            # the state-only paths launch no kernel
    log("differentiable: seconds " + ", ".join(f"{k} {v:.1f}" for k, v in seconds.items())
        + f" = {sum(seconds.values()):.1f} | {card}")
    return launches, k1


# -- 16. multi-process training ------------------------------------------------------


def par_flat_equal(torch, meshlib, tensors, shard):
    """True on every rank when its tensors equal rank 0's bit for bit (rank
    0's broadcast, compared, the verdicts all-reduced)."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    ref = flat.clone()
    meshlib.broadcast_([ref], shard)
    bad = torch.tensor([0.0 if torch.equal(flat, ref) else 1.0], device=flat.device)
    meshlib.all_reduce_(bad, shard)
    return bad.item() == 0.0


def par_all_true(torch, meshlib, ok, shard, device):
    """A verdict of every rank: True when each rank's ``ok`` is."""
    bad = torch.tensor([0.0 if ok else 1.0], device=device)
    meshlib.all_reduce_(bad, shard)
    return bad.item() == 0.0


def par_max(torch, meshlib, x, shard, device):
    """The largest of every rank's ``x`` (a zero-padded all-reduce)."""
    v = torch.zeros(shard.world, device=device, dtype=torch.float64)
    v[shard.rank] = float(x)
    meshlib.all_reduce_(v, shard)
    return float(v.max())


def par_tree_equal(torch, meshlib, a, b) -> bool:
    """Two trees equal leaf for leaf: tensors by torch.equal (shape and
    dtype included), generators by their states."""
    ta, tb = meshlib.tree_items(a, torch.Tensor), meshlib.tree_items(b, torch.Tensor)
    ga, gb = meshlib.tree_items(a, torch.Generator), meshlib.tree_items(b, torch.Generator)
    return (len(ta) == len(tb) and len(ga) == len(gb)
            and all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(x, y)
                    for x, y in zip(ta, tb))
            and all(torch.equal(x.get_state(), y.get_state()) for x, y in zip(ga, gb)))


def par_mem_gb(torch, dev, fn):
    """fn() -> (its result, the peak and the held memory it added on this
    process's allocator, in GB; None on the CPU)."""
    if dev.type != "cuda":
        return fn(), None, None
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    result = fn()
    torch.cuda.synchronize()
    return (result, (torch.cuda.max_memory_allocated() - base) / 1e9,
            (torch.cuda.memory_allocated() - base) / 1e9)


def par_rank_main(rank, coordinator, work, card, device="cuda"):
    """One rank of phase 16 (a process of its own, spawned by
    parallel_phase): parts a-g, each asserted; prints ``PAR_RANK {json}``
    with its launches, seconds and memory and, on rank 0, ``PAR_SUMMARY
    {json}``. ``device`` "cpu" rehearses it on the CPU (with smaller
    constants)."""
    import numpy as np
    import torch
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.models.vit import TensorParallelViTEncoder
    from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    from aerial_gym_simulator_tpu_torch.parallel import mesh as meshlib
    from aerial_gym_simulator_tpu_torch.parallel import scaling
    from aerial_gym_simulator_tpu_torch.parallel.distributed import (initialize_multihost,
                                                                      shard_trainer)
    from aerial_gym_simulator_tpu_torch.rl.population import PopulationTrainer
    from aerial_gym_simulator_tpu_torch.rl.ppo import (PPOConfig, PPOTrainer, build_trainer,
                                                       parse_args)
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import render_camera
    from aerial_gym_simulator_tpu_torch.sim.convert import load_encoder_pickle

    dev = torch.device(device)
    cpu_flag = ["--cpu"] if device == "cpu" else []
    initialize_multihost(coordinator, PAR_RANKS, rank, require=True, backend="gloo")
    dist = meshlib._dist()
    out, seconds, launches, memory = {"backend": dist.get_backend()}, {}, {}, {}

    def counts():
        return {**rc.LAUNCHES, **ac.LAUNCHES}

    # a. a global sum of CUDA tensors across the processes
    t0 = time.perf_counter()
    world = meshlib.make_mesh()
    one = meshlib.env_sharding(world, 8 * PAR_RANKS)
    part = torch.arange(8 * PAR_RANKS, dtype=torch.float32, device=dev)[
        one.offset:one.offset + one.n_local]
    total = meshlib.all_reduce_(part.sum(), one).item()
    n = 8 * PAR_RANKS
    if total != n * (n - 1) / 2:
        raise AssertionError(f"parallel a: global sum {total}")
    out["a_global_sum"] = total
    seconds["a"] = time.perf_counter() - t0

    # b. sharded navigation PPO; first the draw rule against one rank
    t0 = time.perf_counter()
    # each rank builds its block alone (the CLI's --multichip: make_task(...,
    # shard=)); the build-then-cut rank is built beside it, for its memory
    # and to hold the two builds equal bit for bit
    (task, trainer), memory["b build peak"], memory["b held"] = par_mem_gb(
        torch, dev, lambda: build_trainer(parse_args(NAVPPO_ARGS + ["--multichip"] + cpu_flag)))
    sh = trainer.shard
    if task.shard != sh or task.num_envs != sh.n_local:
        raise AssertionError(f"parallel b: the task was not built at its block ({task.num_envs} "
                             f"envs, shard {sh})")
    rows = slice(sh.offset, sh.offset + sh.n_local)

    def build_then_cut():
        built = build_trainer(parse_args(NAVPPO_ARGS + cpu_flag))
        shard_trainer(built[1])
        return built

    (cut_task, cut_trainer), memory["b build-then-cut peak"], memory["b build-then-cut held"] = \
        par_mem_gb(torch, dev, build_then_cut)
    block_equal = (par_tree_equal(torch, meshlib, trainer.env_carry, cut_trainer.env_carry)
                   and par_tree_equal(torch, meshlib, trainer.obs, cut_trainer.obs)
                   and par_tree_equal(torch, meshlib, task.params.scene, cut_task.params.scene)
                   and par_tree_equal(torch, meshlib, trainer.generator, cut_trainer.generator))
    out["b_block_equals_cut"] = par_all_true(torch, meshlib, block_equal, sh, dev)
    cut_task.close()
    del cut_task, cut_trainer
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    acts = torch.from_numpy(np.random.default_rng(16).uniform(
        -1.0, 1.0, (PAR_DRAW_STEPS, NAV_ENVS, 4)).astype(np.float32)).to(dev)

    def steps(step_fn, carry, params, cols):
        gen = carry.rng.get_state()
        depths, obs_all = [], []
        for t in range(PAR_DRAW_STEPS):
            carry, obs, *_ = step_fn(carry, acts[t, cols])
            depths.append(render_camera(params, carry.sim, want_seg=False)[0])
            obs_all.append(obs)
        carry.rng.set_state(gen)                 # the run starts where it was built
        return depths, obs_all

    depths, obs_sh = steps(trainer.step_fn, trainer.env_carry, task.params, rows)
    (ref_task, ref_trainer), memory["b one-rank build peak"], memory["b one-rank held"] = \
        par_mem_gb(torch, dev, lambda: build_trainer(parse_args(NAVPPO_ARGS + cpu_flag)))
    ref_depths, ref_obs = steps(ref_trainer.step_fn, ref_trainer.env_carry, ref_task.params,
                                slice(0, NAV_ENVS))
    depth_equal = all(torch.equal(d, r[rows]) for d, r in zip(depths, ref_depths))
    lat = task.task_config.latent_dim                # the observation's last columns
    state_equal = all(torch.equal(o[:, :-lat], r[rows, :-lat]) for o, r in zip(obs_sh, ref_obs))
    latents_close = all(torch.allclose(o[:, -lat:], r[rows, -lat:], atol=PAR_LATENT_TOL,
                                       rtol=PAR_LATENT_TOL) for o, r in zip(obs_sh, ref_obs))
    latent_err = max(float((o[:, -lat:] - r[rows, -lat:]).abs().max())
                     for o, r in zip(obs_sh, ref_obs))
    out["b_depth_bit_equal"] = par_all_true(torch, meshlib, depth_equal, sh, dev)
    out["b_obs_state_bit_equal"] = par_all_true(torch, meshlib, state_equal, sh, dev)
    out["b_latents_close"] = par_all_true(torch, meshlib, latents_close, sh, dev)
    out["b_latent_max_err"] = par_max(torch, meshlib, latent_err, sh, dev)
    del depths, ref_depths, obs_sh, ref_obs
    seconds["b draw rule"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    history = ppo_iterations(torch, trainer, PAR_NAV_ITERATIONS, f"parallel rank {rank} navppo",
                             card)
    launches["b navppo"] = counts()
    walls = [m["wall_s"] for m in history]
    out["b_s_per_iteration"] = [b - a for a, b in zip([0.0] + walls[:-1], walls)]
    out["b_reward"] = [m["reward_mean"] for m in history]
    out["b_learner_identical"] = par_flat_equal(torch, meshlib,
                                                list(trainer.network.parameters()), sh)
    seconds["b ppo"] = time.perf_counter() - t0

    # d. the training state of b saved by both ranks, restored into one rank
    t0 = time.perf_counter()
    ckpt = os.path.join(work, "navppo_state")
    trainer.save_training_state(ckpt)
    carry_whole = meshlib.gather_env_pytree(trainer.env_carry, sh)
    if rank == 0:
        ref_trainer.restore_training_state(ckpt)
        adam, ref_adam = trainer._adam_state(), ref_trainer._adam_state()
        same = (all(torch.equal(a, b) for a, b in zip(trainer.network.parameters(),
                                                       ref_trainer.network.parameters()))
                and all(torch.equal(adam[i][k], ref_adam[i][k]) for i in adam for k in adam[i])
                and all(torch.equal(trainer.norm[k], ref_trainer.norm[k]) for k in trainer.norm)
                and torch.equal(trainer.lr, ref_trainer.lr))
        whole = [t for t in meshlib.tree_items(carry_whole, torch.Tensor)]
        loaded = [t for t in meshlib.tree_items(ref_trainer.env_carry, torch.Tensor)]
        out["d_learner_bit_equal"] = same
        out["d_carry_equal"] = (len(whole) == len(loaded)
                                and all(torch.equal(a, b) for a, b in zip(whole, loaded)))
        out["d_checkpoint_mb"] = os.path.getsize(
            os.path.join(ckpt, f"iter_{trainer._iter}.pt")) / 1e6
    task.close()
    ref_task.close()
    del trainer, ref_trainer, task, ref_task, carry_whole
    torch.cuda.empty_cache()
    seconds["d"] = time.perf_counter() - t0

    # c. LiDAR-navigation PPO over both ranks (K1 on the 48x120 table)
    t0 = time.perf_counter()
    lidar = port.task_registry.make_task("lidar_navigation_task", num_envs=PAR_LIDAR_ENVS,
                                         seed=7, device=device)
    lcfg = PPOConfig(num_envs=PAR_LIDAR_ENVS, horizon=PAR_LIDAR_HORIZON,
                     minibatch_size=min(8192, PAR_LIDAR_ENVS * PAR_LIDAR_HORIZON), seed=7)
    ltr = PPOTrainer(lidar, lcfg)
    shard_trainer(ltr)
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    ppo_iterations(torch, ltr, 1, f"parallel rank {rank} lidarnav ppo", card)
    launches["c lidarnav"] = counts()
    out["c_learner_identical"] = par_flat_equal(torch, meshlib, list(ltr.network.parameters()),
                                                ltr.shard)
    lidar.close()
    del ltr, lidar
    seconds["c"] = time.perf_counter() - t0

    # e. the tensor-parallel ViT: the shipped encoder, 4 heads a rank, f32
    t0 = time.perf_counter()
    _, enc = load_encoder_pickle(str(NETWORKS / "vit_depth_encoder.pkl"), (135, 240))
    enc = enc.to(dev).float().eval()
    g = torch.Generator(device=dev)
    g.manual_seed(16)
    x = torch.rand((PAR_TP_BATCH, 135, 240, 1), generator=g, device=dev)
    with torch.no_grad():
        mean, logvar = enc(x)
    tp = TensorParallelViTEncoder(enc, rank, PAR_RANKS)
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    (t_mean, t_logvar), tp_ms = timed(torch, lambda: tp(x))
    launches["e tp_vit"] = counts()
    _, whole_ms = timed(torch, lambda: enc(x))
    out["e_heads_per_rank"] = tp.blocks[0].num_heads
    out["e_max_err"] = par_max(torch, meshlib, max(float((t_mean - mean).abs().max()),
                                                   float((t_logvar - logvar).abs().max())),
                               one, dev)
    out["e_ms"] = {"tensor_parallel": tp_ms, "whole": whole_ms}
    del enc, tp, x, mean, logvar, t_mean, t_logvar
    torch.cuda.empty_cache()
    seconds["e"] = time.perf_counter() - t0

    # f. the population dealt over the ranks, against the unsharded one
    t0 = time.perf_counter()
    pp = PAR_POP
    pcfg = PPOConfig(num_envs=pp["num_envs"], horizon=pp["horizon"],
                     minibatch_size=min(8192, pp["num_envs"] * pp["horizon"]), seed=42)
    lrs = list(np.geomspace(1e-4, 1e-3, pp["num_seeds"]).astype(np.float32))
    factory = lambda s, shard=None: port.task_registry.make_task(
        "position_setpoint_task", num_envs=pp["num_envs"], seed=s, device=device, shard=shard)

    def sharded_population():
        # no member is built until shard(), which builds this rank's alone
        built = PopulationTrainer(factory, pcfg, pp["num_seeds"], member_lrs=lrs, build=False)
        built.shard()
        return built

    pop, memory["f build peak"], memory["f held"] = par_mem_gb(torch, dev, sharded_population)
    out["f_members_built"] = sum(m is not None for m in pop.members)
    steps_total = pp["iterations"] * pp["num_envs"] * pp["horizon"]
    hist = pop.train(total_env_steps=steps_total, log_every=1, pbt_every=1)
    ref = PopulationTrainer(factory, pcfg, pp["num_seeds"], member_lrs=lrs)
    ref.train(total_env_steps=steps_total, log_every=1, pbt_every=1)
    equal = all(
        all(torch.equal(a, b) for a, b in zip(pop.members[i].network.parameters(),
                                              ref.members[i].network.parameters()))
        and torch.equal(pop.members[i].lr, ref.members[i].lr)
        and all(torch.equal(pop.members[i].norm[k], ref.members[i].norm[k])
                for k in ref.members[i].norm)
        for i in pop.local)
    out["f_members_bit_equal"] = par_all_true(torch, meshlib, equal, one, dev)
    out["f_local_members"] = pop.local
    out["f_env_steps_per_s"] = float(hist[-1]["env_steps_per_s"])
    del pop, ref
    seconds["f"] = time.perf_counter() - t0

    # g. the rehearsals' legs in these processes (no start-up of their own):
    #    position PPO at 2 x E envs over both ranks, then, the group gone, at
    #    E and at 2 x E on rank 0 alone; the ranks share the card, so the
    #    ratios check the harness and are not efficiencies
    t0 = time.perf_counter()
    rh = PAR_REHEARSAL
    legs = {"envs_per_process": rh["envs_per_device"]}
    leg = lambda n: scaling.timed_train_steps_per_s(
        "position_setpoint_task", n, rh["horizon"], rh["warmup_iters"], rh["timed_iters"],
        device=device)
    legs["two_ranks"] = leg(PAR_RANKS * rh["envs_per_device"])
    meshlib.barrier(one, dev)
    dist.destroy_process_group()
    if rank == 0:
        legs["one_rank_weak"] = leg(rh["envs_per_device"])
        legs["one_rank_strong"] = leg(PAR_RANKS * rh["envs_per_device"])
        out["g"] = legs
    seconds["g"] = time.perf_counter() - t0
    out["seconds"] = seconds
    print("PAR_RANK " + json.dumps({"rank": rank, "launches": launches, "seconds": seconds,
                                    "memory_gb": memory}), flush=True)
    if rank == 0:
        print("PAR_SUMMARY " + json.dumps(out), flush=True)
    return 0


def poll(fn, what):
    """fn() until it returns something true, or raise at DEADLINE_S."""
    deadline = time.perf_counter() + DEADLINE_S
    while time.perf_counter() < deadline:
        got = fn()
        if got:
            return got
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {what}")


def viewer_subphase(torch, port, rc, card, work):
    """17a: the OfflineViewer on the obstacle env at VIEWER_ENVS, each
    frame's K2 held to the plain version. -> (launches, K2 record, env)."""
    from aerial_gym_simulator_tpu_torch.viewer import OfflineViewer
    env = port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                      "base_quadrotor_with_camera", "lee_velocity_control",
                                      num_envs=VIEWER_ENVS, seed=17)
    zeros = torch.zeros((VIEWER_ENVS, 4), device=env.device)
    W, H = VIEWER_SIZE
    hits, frame_ms, exact = [], [], 0
    zero_counts(rc.LAUNCHES)
    for mode in ("follow_robot", "fixed"):
        v = OfflineViewer(env.params, width=W, height=H, mode=mode)
        scene_hits = v.scene_hits
        v.scene_hits = lambda state: hits.append(scene_hits(state)) or hits[-1]
        for _ in range(VIEWER_FRAMES):
            env.step(zeros)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            img = v.render(env.state)             # K2, marker, colouring, copy to the host
            frame_ms.append((time.perf_counter() - t0) * 1e3)
            *args, n_tri = v.cast_inputs(env.state)
            ref = rc.raycast_reference(*args, want_seg=True, n_tri=n_tri)
            exact += int(torch.equal(hits[-1][0], ref[0][0])
                         and torch.equal(hits[-1][1], ref[1][0]))
            if img.shape != (H, W, 3) or img.dtype.name != "uint8":
                raise AssertionError(f"deploy a: frame {img.shape} {img.dtype}")
        if mode == "follow_robot":
            v.save_avi(os.path.join(work, "viewer.avi"), fps=10)
            avi_bytes = os.path.getsize(os.path.join(work, "viewer.avi"))
    launches = dict(rc.LAUNCHES)
    n = 2 * VIEWER_FRAMES
    if exact != n or launches["raycast_seg"] != n or sum(launches.values()) != n:
        raise AssertionError(f"deploy a: {exact} of {n} frames bit-equal to the plain version, "
                             f"launches {launches} (one K2 a frame)")
    if avi_bytes <= VIEWER_FRAMES * W * H * 3:
        raise AssertionError(f"deploy a: the .avi holds {avi_bytes} bytes")
    rec, _ = time_mode(torch, rc, tuple(args), n_tri, "raycast_seg", card, "viewer")
    med = sorted(frame_ms)[len(frame_ms) // 2]
    log(f"deploy a: OfflineViewer {W}x{H} on env 0 of {VIEWER_ENVS} ({args[1].shape[1]} prims), "
        f"{VIEWER_FRAMES} frames follow + {VIEWER_FRAMES} fixed: K2 bit-equal {exact}/{n}, "
        f"launches {launches}; whole frame (K2, marker, colouring, copy) median {med:.3f} ms "
        f"(min {min(frame_ms):.3f}, max {max(frame_ms):.3f}), K2 {rec['ms']:.3f} ms; .avi "
        f"{avi_bytes} bytes | {card}")
    return launches, dict(rec, launches=launches["raycast_seg"], library_ms=None,
                          frame_ms_median=med), env


def live_web_subphase(torch, rc, env, card):
    """17b: a LiveViewer's key map and a WebViewer over HTTP on ``env``. ->
    launches (their frames' K2)."""
    import threading
    import urllib.request
    from aerial_gym_simulator_tpu_torch.viewer import LiveViewer, WebViewer
    W, H = VIEWER_SIZE
    zero_counts(rc.LAUNCHES)
    lv = LiveViewer(env, width=W, height=H, backend="Agg")
    frame = lv.step_once()
    lv.on_key("p")
    before = env.state.pos.clone()
    lv.step_once()
    paused_still = torch.equal(env.state.pos, before)
    lv.on_key(" ")
    lv.on_key("]")
    lv.on_key("f")
    lv.on_key("s")
    lv._frame_i = 0
    skipped, due = lv.step_once(), lv.step_once()
    lv.on_key("q")
    ok = (frame is not None and frame.shape == (H, W, 3) and paused_still and lv.env_index == 1
          and lv.viewer.env_id == 1 and lv.viewer.mode == "fixed" and skipped is None
          and due is not None and lv.quit)
    try:
        import matplotlib  # noqa: F401
        lv.quit = False
        lv.run(max_steps=2)
        drawn = "run() drew 2 steps on Agg"
    except ImportError:
        drawn = "matplotlib not installed here: run() not driven"
    if not ok:
        raise AssertionError("deploy b: the LiveViewer's key map")

    wv = WebViewer(env, width=W, height=H)
    thread = threading.Thread(target=wv.run, kwargs=dict(port=0), daemon=True)
    thread.start()
    try:
        host, port_ = poll(lambda: wv.server_address, "the web viewer's server")[:2]
        base = f"http://{host}:{port_}"

        def get(path):
            try:
                with urllib.request.urlopen(base + path, timeout=30) as r:
                    return r.status, r.read()
            except urllib.error.HTTPError as e:
                return e.code, b""

        def key(k):
            req = urllib.request.Request(base + "/key", data=json.dumps({"key": k}).encode(),
                                         method="POST")
            with urllib.request.urlopen(req, timeout=30) as r:
                return r.status

        png = poll(lambda: (lambda st, b: b if st == 200 else None)(*get("/frame.png")),
                   "a frame")
        statuses = [key("p")]
        poll(lambda: json.loads(get("/status")[1])["paused"], "the pause")
        statuses += [key("]")]
        status = poll(lambda: (lambda st: st if st["env"] == 1 else None)(
            json.loads(get("/status")[1])), "the env switch")
        statuses += [key("q")]
        thread.join(timeout=DEADLINE_S)
    finally:
        wv.quit = True
        thread.join(timeout=DEADLINE_S)
    if png[:8] != b"\x89PNG\r\n\x1a\n" or statuses != [204] * 3 or thread.is_alive():
        raise AssertionError(f"deploy b: web viewer png {png[:8]!r}, key statuses {statuses}")
    launches = dict(rc.LAUNCHES)
    log(f"deploy b: LiveViewer key map (pause, env, mode, sync, quit) held, {drawn}; WebViewer "
        f"on {host}:{port_}: /frame.png {len(png)} bytes of PNG, /key 204 x 3, /status {status}; "
        f"launches {launches} | {card}")
    return launches


def deploy_chain_subphase(torch, port, card, work):
    """17c: the shipped position and radar policies through
    build_deploy_module, TorchScript, save and load on the card, against
    the port's runners at DEPLOY_OBS observations."""
    from aerial_gym_simulator_tpu_torch.sim2real import convert_model_to_script_model
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
    from aerial_gym_simulator_tpu_torch.sim2real.torch_export import (
        RecurrentPolicyDeploy, build_deploy_module)
    task = port.task_registry.make_task("position_setpoint_task", num_envs=DEPLOY_OBS, seed=17)
    dev = task.device

    def scripted(module, name):
        path = os.path.join(work, f"{name}.pt")
        torch.jit.save(torch.jit.script(module), path)
        return torch.jit.load(path, map_location=dev)

    g = torch.Generator(device=dev)
    g.manual_seed(17)
    task.reset()
    for _ in range(3):
        obs, *_ = task.step(torch.rand((DEPLOY_OBS, 4), generator=g, device=dev) * 2 - 1)
    x = obs["observations"]
    lo, hi = (torch.tensor(v, device=dev) for v in DEPLOY_LIMITS)
    module = build_deploy_module(str(POSITION_POLICY), *DEPLOY_LIMITS)
    m = scripted(module, "position")
    cpu_file = torch.jit.load(convert_model_to_script_model(
        str(POSITION_POLICY), os.path.join(work, "position_cpu.pt"), *DEPLOY_LIMITS),
        map_location=dev)
    ref = load_policy_npz(str(POSITION_POLICY))
    with torch.no_grad():
        for _ in range(3):          # past the JIT's profiling runs: its optimized graph
            m(x), cpu_file(x)
        a, a_file, r = m(x), cpu_file(x), ref(x)
        scaled = m.rescale_actions(a)
        edges = m.rescale_actions(torch.stack([-torch.ones(4, device=dev),
                                               torch.zeros(4, device=dev),
                                               torch.ones(4, device=dev)]))
    err = float((a - r).abs().max())
    err_file = float((a_file - r).abs().max())
    want = a * (hi - lo) / 2.0 + (hi + lo) / 2.0
    rescale_err = float((scaled - want).abs().max())
    edges_err = float((edges - torch.stack([lo, (hi + lo) / 2.0, hi])).abs().max())
    ms = event_ms(torch, lambda: m(x), 20)
    ref_ms = event_ms(torch, lambda: ref(x), 20)
    on_card = module.norm_mean.device == dev and m.norm_mean.device == dev
    task.close()

    rmod = build_deploy_module(str(RADAR_NAV_POLICY))
    rm = scripted(rmod, "radar")
    # the scripted module as a user runs it (past its profiling runs the JIT
    # fuses the gate arithmetic into kernels of its own), and unscripted
    variants = {"scripted": rm, "eager": rmod}
    rref = load_policy_npz(str(RADAR_NAV_POLICY), num_envs=DEPLOY_OBS)
    hs = {k: rm.initial_state(DEPLOY_OBS) for k in variants}
    r_errs = dict.fromkeys(variants, 0.0)
    with torch.no_grad():
        for t in range(DEPLOY_RADAR_STEPS):
            xr = torch.randn((DEPLOY_OBS, rref.norm_mean.shape[0]), generator=g, device=dev)
            ar = rref(xr)
            for k, module in variants.items():
                a_k, hs[k] = module(xr, hs[k])
                r_errs[k] = max(r_errs[k], float((a_k - ar).abs().max()))
            if t == DEPLOY_RADAR_STEPS // 2:      # an episode ends for ~30% of the envs
                done = torch.rand(DEPLOY_OBS, generator=g, device=dev) < 0.3
                hs = {k: h * (~done).to(h.dtype)[:, None] for k, h in hs.items()}
                rref.reset(done)
    r_err = max(r_errs.values())
    log(f"deploy c: position policy scripted and loaded on the card ({on_card}): {DEPLOY_OBS} "
        f"observations of the position task, max |a - MLPPolicy| {err:.3g} (the CPU-saved file "
        f"{err_file:.3g}; bar {DEPLOY_TOL}), rescale_actions {rescale_err:.3g} (edges "
        f"{edges_err:.3g}), {ms:.3f} ms a call against MLPPolicy {ref_ms:.3f} ms; radar GRU "
        f"through RecurrentPolicyDeploy {isinstance(rmod, RecurrentPolicyDeploy)} for "
        f"{DEPLOY_RADAR_STEPS} steps with a reset against RecurrentPolicy, max err "
        + ", ".join(f"{k} {v:.3g}" for k, v in r_errs.items()) + f" (bar {DEPLOY_TOL}) | {card}")
    if not (on_card and isinstance(rmod, RecurrentPolicyDeploy)
            and max(err, err_file, r_err) <= DEPLOY_TOL and max(rescale_err, edges_err) <= 1e-6):
        raise AssertionError("deploy c: the deployment chain")
    return {"max_abs_err": max(err, err_file, r_err), "ms": ms, "mlp_policy_ms": ref_ms,
            "radar_max_abs_err": r_errs}


def nav_interface_subphase(torch, port, rc, ac, card):
    """17d: RL_Nav_Interface flying the navigation task (conv VAE) for
    DEPLOY_NAV_STEPS steps. -> (launches, env 0's odometry of each step)."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.sim2real import RL_Nav_Interface
    from aerial_gym_simulator_tpu_torch.sim2real.policy import load_policy_npz
    ckpt = str(NETWORKS / "navigation_policy.npz")
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              vae_params_path=str(NETWORKS / "depth_vae.pkl"))
    task = port.task_registry.make_task("navigation_task", num_envs=NAV_ENVS, seed=17,
                                        task_config=cfg)
    nav = RL_Nav_Interface(num_envs=NAV_ENVS, checkpoint_path=ckpt)
    policy = load_policy_npz(ckpt)
    obs, *_ = task.reset()
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    equal, odoms, step_ms = True, [], []
    for _ in range(DEPLOY_NAV_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = nav.step(obs)                          # numpy actions on the host
        step_ms.append((time.perf_counter() - t0) * 1e3)
        equal &= bool(np.array_equal(a, policy(obs["observations"]).cpu().numpy()))
        obs, *_ = task.step(torch.as_tensor(a, device=task.device))
        o = task.sim_env.get_obs()
        odoms.append([o[k][0].cpu().numpy() for k in ("robot_position", "robot_orientation",
                                                       "robot_body_linvel", "robot_body_angvel")])
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    finite = bool(torch.isfinite(obs["observations"]).all())
    task.close()
    med = sorted(step_ms)[len(step_ms) // 2]
    log(f"deploy d: RL_Nav_Interface on navigation_policy.npz, the navigation task at {NAV_ENVS} "
        f"envs with depth_vae.pkl for {DEPLOY_NAV_STEPS} steps: actions equal to the port's "
        f"policy {equal}, finite {finite}, interface call median {med:.3f} ms (actions to the "
        f"host), launches {launches} | {card}")
    want = {"raycast_depth": DEPLOY_NAV_STEPS}
    if not (equal and finite) or any(v != want.get(k, 0) for k, v in launches.items()):
        raise AssertionError(f"deploy d: equal {equal}, finite {finite}, launches {launches}")
    return launches, odoms


def ros_subphase(torch, odoms, card):
    """17e: NavPolicyNode over the loopback, fed env 0's odometry."""
    import threading
    import numpy as np
    from aerial_gym_simulator_tpu_torch.sim2real import ros_loopback
    bus = ros_loopback.install(rate_scale=ROS_RATE_SCALE)
    from aerial_gym_simulator_tpu_torch.sim2real.ros_node import NavPolicyNode
    ckpt = str(NETWORKS / "navigation_policy.npz")
    node = NavPolicyNode(ckpt, goal=(5.0, 0.0, 1.5))
    thread = threading.Thread(target=node.spin, daemon=True)
    thread.start()
    command = lambda m: np.array([m.twist.linear.x, m.twist.linear.y, m.twist.linear.z,
                                  m.twist.angular.z])
    first_odom = ros_loopback.make_odometry(*odoms[0])
    bus.publish("odometry", first_odom)
    poll(lambda: bus.published.get("cmd_vel"), "the node's first command")
    t0 = time.perf_counter()
    k = 0
    while time.perf_counter() - t0 < ROS_SECONDS:
        bus.publish("odometry", ros_loopback.make_odometry(*odoms[k % len(odoms)]))
        k += 1
        time.sleep(1.0 / (10.0 * ROS_RATE_SCALE))
    bus.shutdown.set()
    thread.join(timeout=DEADLINE_S)
    seconds = time.perf_counter() - t0
    cmds = bus.published.get("cmd_vel", [])
    first = command(cmds[0][1])
    ref = NavPolicyNode(ckpt, goal=(5.0, 0.0, 1.5))
    ref._odom_cb(first_odom)
    direct = np.asarray(ref.policy.step({"observations": ref.build_obs()[None]})[0])[:4]
    err = float(np.abs(first - direct).max())
    acts = np.array([command(m) for _, m in cmds])
    ticks = ROS_SECONDS * 10.0 * ROS_RATE_SCALE
    log(f"deploy e: NavPolicyNode over the loopback at {ROS_RATE_SCALE:g}x real time for "
        f"{seconds:.2f} s, {k} odometry messages from env 0: {len(cmds)} commands "
        f"({len(cmds) / seconds:.1f} a second; the node's rate {10.0 * ROS_RATE_SCALE:g}), "
        f"first command against the policy run directly {err:.3g} (bar {DEPLOY_TOL}), finite "
        f"{bool(np.isfinite(acts).all())}, spin ended {not thread.is_alive()} | {card}")
    if not (len(cmds) >= 0.5 * ticks and err <= DEPLOY_TOL and np.isfinite(acts).all()
            and not thread.is_alive()):
        raise AssertionError(f"deploy e: {len(cmds)} commands for {ticks:g} ticks, first "
                             f"command err {err}")
    return {"commands": len(cmds), "seconds": seconds, "first_command_err": err}


def deployment_phase(torch, port, rc, ac, card):
    """Phase 17: the viewers (K2) and the deployment surface (K1 in d). ->
    (launches of the phase by kernel, K2's record at the viewer's shapes,
    the deployment checks)."""
    t_all = time.perf_counter()
    seconds = {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        la, k2_viewer, env = viewer_subphase(torch, port, rc, card, work)
        seconds["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lb = live_web_subphase(torch, rc, env, card)
        del env
        torch.cuda.empty_cache()
        seconds["b"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        chain = deploy_chain_subphase(torch, port, card, work)
        seconds["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ld, odoms = nav_interface_subphase(torch, port, rc, ac, card)
    seconds["d"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ros = ros_subphase(torch, odoms, card)
    seconds["e"] = time.perf_counter() - t0
    launches = {k: la.get(k, 0) + lb.get(k, 0) + ld.get(k, 0) for k in ld}
    log(f"deploy: phase 17 {time.perf_counter() - t_all:.1f} s (" +
        ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + f"), launches {launches} | {card}")
    return launches, {"viewer": la, "live_web": lb, "nav_interface": ld}, k2_viewer, \
        {"deploy_chain": chain, "ros": ros}


def profile_one(torch, prof, rc, ac, card, label, run, want):
    """18a: one profiler run (``run()`` -> profile_task's report) with every
    launch counter zeroed just before it; ``want(calls)`` -> the expected
    counts. -> (launches, the report's numbers)."""
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    t0 = time.perf_counter()
    rep = run()
    seconds = time.perf_counter() - t0
    launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    expected = want(rep["calls"])
    if launches != expected:
        raise AssertionError(f"profile {label}: launches {launches}, expected {expected}")
    if not rep["rows"]:
        raise AssertionError(f"profile {label}: an empty op table")
    idle = rep["idle_share"]
    log(f"tools: profile {label} @ {rep['num_envs']} envs: {rep['wall_ms']:.2f} ms wall, "
        f"{rep['env_steps_per_s']:.1f} env-steps/s, {rep['device_ms']:.2f} ms summed device "
        f"time (idle share {idle:.3f}), {len(rep['rows'])} ops in the table, {rep['calls']} "
        f"calls, {seconds:.1f} s | {card}")
    return launches, {"wall_ms": rep["wall_ms"], "device_ms": rep["device_ms"],
                      "idle_share": idle, "env_steps_per_s": rep["env_steps_per_s"],
                      "calls": rep["calls"], "top_op": rep["rows"][0][0][:80],
                      "top_op_ms": rep["rows"][0][1]}


def profile_subphase(torch, port, rc, ac, card, work):
    """18a: the profiler's command line on the bench state step and on one
    PPO iteration, and its profile_task on the navigation step with the
    shipped ViT. -> (launches of the navigation run, numbers by run)."""
    from aerial_gym_simulator_tpu_torch.utils import profiling as prof

    none = lambda calls: {**{k: 0 for k in rc.LAUNCHES}, **attention_counts(ac)}
    out = {}
    _, out["state_step"] = profile_one(
        torch, prof, rc, ac, card, "state step",
        lambda: prof.main(PROFILE_STATE_ARGS + ["--trace_dir", os.path.join(work, "state")]), none)

    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              vae_params_path=str(NETWORKS / "vit_depth_encoder.pkl"))
    task = port.task_registry.make_task("navigation_task", num_envs=NAV_ENVS, seed=99,
                                        task_config=cfg)
    nav_dir = os.path.join(work, "nav")
    want_nav = lambda calls: {**{k: 0 for k in rc.LAUNCHES}, "raycast_depth": calls,
                              **attention_counts(ac, attention_fwd=4 * calls)}
    nav_launches, out["navigation_step"] = profile_one(
        torch, prof, rc, ac, card, "navigation step (shipped ViT)",
        lambda: prof.profile_task(task, iters=PROFILE_NAV_ITERS, trace_dir=nav_dir,
                                  label="navigation_task env step (shipped ViT)"), want_nav)
    rows, _ = prof.op_breakdown(nav_dir, iters=PROFILE_NAV_ITERS, top_k=10 ** 6)
    named = {k: [(n, ms) for n, ms, _ in rows if k in n] for k in ("raycast", "attention")}
    if not all(named.values()):
        raise AssertionError(f"profile navigation step: the table names no {named}")
    for k, hits in named.items():
        out["navigation_step"][f"{k}_ms"] = sum(ms for _, ms in hits)
        log(f"tools: profile navigation step: {k} kernels in the table "
            + ", ".join(f"{n[:60]} {ms:.3f} ms" for n, ms in hits))
    task.close()
    del task
    torch.cuda.empty_cache()

    _, out["ppo_iteration"] = profile_one(
        torch, prof, rc, ac, card, "PPO iteration",
        lambda: prof.main(PROFILE_PPO_ARGS + ["--trace_dir", os.path.join(work, "ppo")]), none)
    return nav_launches, out


def norm_rel(a, b):
    """Largest difference over the largest magnitude of ``b`` (CPU)."""
    b = b.cpu()
    return float((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))


def bem_subphase(torch, card):
    """18b: NeuroBEM on the card against the CPU, the quad, the batch."""
    from aerial_gym_simulator_tpu_torch.examples import bem_standalone as bem

    bp, bp_cpu = bem.default_params(), bem.default_params("cpu")
    err = 0.0
    for cond in BEM_CONDITIONS:
        card_out, cpu_out = bem.bem_rotor_wrench(bp, *cond), bem.bem_rotor_wrench(bp_cpu, *cond)
        err = max([err] + [norm_rel(a, b) for a, b in zip(card_out, cpu_out)])
    if not err <= BEM_TOL:
        raise AssertionError(f"bem: the single rotor on the card against the CPU {err:.3g}")
    _, _, forces, torques = bem.main([])
    thrust = -forces[:, 2]
    if not (torch.isfinite(forces).all() and bool((thrust[1:] > thrust[:-1]).all())):
        raise AssertionError(f"bem: the quad's rotor thrusts {thrust.tolist()}")
    gen = torch.Generator(device=TOOLS_DEVICE)
    gen.manual_seed(18)
    u = lambda lo, hi: lo + (hi - lo) * torch.rand(BEM_BATCH, generator=gen, device=TOOLS_DEVICE)
    spin = torch.tensor([1.0, -1.0, 1.0, -1.0], device=TOOLS_DEVICE).expand(BEM_BATCH)
    args = (u(1500.0, 2500.0), u(0.0, 8.0), u(-2.0, 2.0), u(-1.0, 1.0), u(-1.0, 1.0), spin)
    call = lambda: bem.bem_rotor_wrench_batched(bp, *args)
    ms = event_ms(torch, call, 3)
    f, t = call()
    if not (f.shape == BEM_BATCH + (3,) and torch.isfinite(f).all() and torch.isfinite(t).all()):
        raise AssertionError("bem: the batch's wrench is not finite")
    k = BEM_CHECK_ROTORS
    head = [a.reshape(-1)[:k].cpu() for a in args]
    f_cpu, t_cpu = bem.bem_rotor_wrench_batched(bp_cpu, *head)
    batch_err = max(norm_rel(f.reshape(-1, 3)[:k], f_cpu), norm_rel(t.reshape(-1, 3)[:k], t_cpu))
    if not batch_err <= BEM_BATCH_TOL:
        raise AssertionError(f"bem: the batch's first rotors against the CPU {batch_err:.3g}")
    n = BEM_BATCH[0] * BEM_BATCH[1]
    log(f"tools: bem single rotor card vs CPU {err:.3g} of the largest component (bar "
        f"{BEM_TOL}); quad thrusts {[round(float(x), 4) for x in thrust]} N; {BEM_BATCH[0]} x "
        f"{BEM_BATCH[1]} rotors {ms:.2f} ms a call ({n / ms * 1e3:.4g} rotors/s), the first "
        f"{k} against the CPU {batch_err:.3g} | {card}")
    return {"single_err": err, "batch_ms": ms, "batch_err": batch_err}


def gradient_examples_subphase(torch, card):
    """18b: the gradient sys-id, the trajectory optimization and the
    controller tuning on the card."""
    from aerial_gym_simulator_tpu_torch.examples import differentiable_sysid_example as dsys
    from aerial_gym_simulator_tpu_torch.examples import trajectory_optimization_example as traj
    from aerial_gym_simulator_tpu_torch.examples import tune_controllers as tune
    from aerial_gym_simulator_tpu_torch.sim.convert import (
        params_from_numpy, record_to_numpy, state_from_numpy)

    out = {}
    n, steps, iters = SYSID_ARGS["num_envs"], SYSID_ARGS["steps"], SYSID_ARGS["iters"]
    env = dsys.build(n)
    actions = dsys.excitation(n, steps)
    rollout = dsys.make_rollout(env.params, env.state, actions)
    with torch.no_grad():
        measured = rollout(dsys.theta_tensors(dsys.TRUE_THETA, TOOLS_DEVICE))
    first = {}

    def keep_first(it, loss, log_theta):
        if it == 0:
            first.update({k: v.grad.detach().cpu().clone() for k, v in log_theta.items()})

    t0 = time.perf_counter()
    log_theta, losses = dsys.identify(rollout, measured, iters, 0.05, on_iter=keep_first)
    torch.cuda.synchronize()
    s_it = (time.perf_counter() - t0) / iters
    cpu_roll = dsys.make_rollout(params_from_numpy(record_to_numpy(env.params), "cpu"),
                                 state_from_numpy(record_to_numpy(env.state), "cpu"), actions.cpu())
    with torch.no_grad():
        cpu_measured = cpu_roll(dsys.theta_tensors(dsys.TRUE_THETA, "cpu"))
    lt_cpu = {k: torch.log(v).requires_grad_()
              for k, v in dsys.theta_tensors(dsys.INITIAL_THETA, "cpu").items()}
    dsys.sysid_loss(cpu_roll, cpu_measured, lt_cpu).backward()
    g_card = torch.cat([first["tau"].reshape(1), first["drag"]])
    g_cpu = torch.cat([lt_cpu["tau"].grad.reshape(1), lt_cpu["drag"].grad])
    rel = float(((g_card - g_cpu).abs() / g_cpu.abs()).max())
    losses = losses.cpu()
    th = {k: torch.exp(v.detach()).cpu() for k, v in log_theta.items()}
    log(f"tools: differentiable_sysid {n} envs x {steps} steps, {iters} Adam iterations "
        f"{s_it:.3f} s each: loss {float(losses[0]):.4g} -> {float(losses[-1]):.4g}, tau "
        f"{float(th['tau']):.4f}, drag {th['drag'].numpy().round(3)}; the first gradient "
        f"against the CPU's {rel:.3g} relative | {card}")
    if not (torch.isfinite(losses).all() and rel <= 1e-3 and losses[-1] < losses[0]):
        raise AssertionError(f"differentiable_sysid: relative {rel}, losses {losses.tolist()}")
    out["sysid"] = {"s_per_iteration": s_it, "first_grad_rel": rel,
                    "loss": [float(losses[0]), float(losses[-1])]}
    del env, rollout, cpu_roll

    steps, iters = TRAJ_ARGS["steps"], TRAJ_ARGS["iters"]
    params, state0 = traj.build(1)
    goal = torch.tensor([1.0, 1.0, 1.0], device=TOOLS_DEVICE)
    _, cost = traj.make_cost(params, state0, goal)
    t0 = time.perf_counter()
    _, costs = traj.optimize(cost, torch.full((steps, 1, 4), traj.HOVER_THRUST, device=TOOLS_DEVICE),
                             iters, 0.05)
    torch.cuda.synchronize()
    s_it = (time.perf_counter() - t0) / iters
    costs = costs.cpu()
    log(f"tools: trajectory_optimization 1 env x {steps} steps, {iters} iterations "
        f"{s_it:.3f} s each: costs " + ", ".join(f"{float(c):.5f}" for c in costs) + f" | {card}")
    # the recipe's first Adam step (0.05 N on every thrust) overshoots from
    # hover, in the JAX script too (3.2 -> 39.1 on the CPU); the cost falls after it
    if not (torch.isfinite(costs).all() and costs[-1] < costs[1]):
        raise AssertionError(f"trajectory_optimization: costs {costs.tolist()}")
    out["trajectory"] = {"s_per_iteration": s_it, "cost": [float(costs[0]), float(costs[-1])]}

    t0 = time.perf_counter()
    metrics = {}
    for controller, axis, target, label in tune.CASES:
        t, y = tune.run_axis(controller, axis, target, TUNE_ARGS["steps"], TUNE_ARGS["num_envs"],
                             "base_quadrotor")
        m = tune.step_response_metrics(t, y, target)
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"tune_controllers {label}: {m}")
        metrics[label] = m
    torch.cuda.synchronize()
    s_resp = time.perf_counter() - t0
    log(f"tools: tune_controllers {TUNE_ARGS['num_envs']} envs x {TUNE_ARGS['steps']} steps, "
        f"4 responses {s_resp:.1f} s: " + "; ".join(
            f"{k} rise {m['rise_time']:.3f} s overshoot {m['overshoot_pct']:.1f}% settle "
            f"{m['settling_time']:.3f} s sse {m['steady_state_error']:.4f}"
            for k, m in metrics.items()) + f" | {card}")
    t0 = time.perf_counter()
    kp, kv, costs = tune.grad_tune("base_quadrotor", steps=TUNE_ARGS["grad_steps"],
                                   iters=TUNE_ARGS["grad_iters"], echo=False)
    torch.cuda.synchronize()
    s_it = (time.perf_counter() - t0) / TUNE_ARGS["grad_iters"]
    costs = costs.cpu()
    log(f"tools: tune_controllers --grad {TUNE_ARGS['grad_steps']} steps x 4 envs, "
        f"{TUNE_ARGS['grad_iters']} iterations {s_it:.3f} s each: cost {float(costs[0]):.4f} -> "
        f"{float(costs[-1]):.4f}, K_pos {kp.cpu().numpy().round(3)}, K_vel "
        f"{kv.cpu().numpy().round(3)} | {card}")
    if not (torch.isfinite(costs).all() and costs[-1] < costs[0]):
        raise AssertionError(f"tune_controllers --grad: costs {costs.tolist()}")
    out["tune"] = {"responses_s": s_resp, "grad_s_per_iteration": s_it,
                   "cost": [float(costs[0]), float(costs[-1])]}
    return out


def tools_phase(torch, port, rc, ac, card):
    """Phase 18: the profiler (K1 and K5 on the navigation step) and the
    capability examples. -> (launches of the phase, its numbers)."""
    import numpy as np
    from aerial_gym_simulator_tpu_torch.examples import imu_data_collection as imu
    from aerial_gym_simulator_tpu_torch.examples import sys_id

    t_all = time.perf_counter()
    seconds, numbers = {}, {}
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        launches, numbers["profile"] = profile_subphase(torch, port, rc, ac, card, work)
        seconds["a"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        numbers["bem"] = bem_subphase(torch, card)
        seconds["bem"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        err = 0.0
        for scheme in ("euler", "rk4"):
            args = ("base_quadrotor", scheme, 0.01, 100, 1.5)
            diff = sys_id.simulate_step_response(*args) - sys_id.simulate_step_response(*args, "cpu")
            err = max(err, float(abs(diff).max()))
        if not err <= 1e-6:
            raise AssertionError(f"sys_id: the card's step responses against the CPU's {err}")
        path = os.path.join(work, "imu.csv")
        rows = imu.main(["--steps", str(IMU_COLLECT_STEPS), "--out", path])
        if not (rows.shape == (IMU_COLLECT_STEPS, 7) and np.isfinite(rows).all()):
            raise AssertionError(f"imu_data_collection: rows {rows.shape} not finite")
        seconds["sys_id+imu"] = time.perf_counter() - t0
        log(f"tools: sys_id euler and rk4 on the card against the CPU {err:.3g} (bar 1e-6); "
            f"imu_data_collection {IMU_COLLECT_STEPS} rows, mean az {rows[:, 3].mean():.3f} "
            f"m/s^2 | {card}")
        numbers["sys_id_err"] = err
        t0 = time.perf_counter()
        numbers.update(gradient_examples_subphase(torch, card))
        seconds["gradients"] = time.perf_counter() - t0
    log(f"tools: phase 18 {time.perf_counter() - t_all:.1f} s (" +
        ", ".join(f"{k} {v:.1f}" for k, v in seconds.items()) + f"), launches {launches} | {card}")
    return launches, numbers


def parallel_phase(torch, rc, ac, card, navppo_check):
    """Phase 16: parts a-g in PAR_RANKS processes of this script on the one
    card (par_rank_main), their lines relayed, every verdict asserted.
    Returns {kernel: launches summed over the ranks} and the per-rank
    counts."""
    from aerial_gym_simulator_tpu_torch.parallel import multiproc
    t_all = time.perf_counter()
    with tempfile.TemporaryDirectory() as work:
        port_ = multiproc.free_port()
        argvs = [[sys.executable, os.path.abspath(__file__), "--parallel-rank", str(r),
                  "--coordinator", f"127.0.0.1:{port_}", "--work", work, "--card", card]
                 for r in range(PAR_RANKS)]
        rcs, outputs = multiproc.spawn(argvs, PAR_TIMEOUT, env=multiproc.worker_env(threads=2))
    out = parallel_report(rcs, outputs, card, navppo_check)
    log(f"parallel: phase 16 {time.perf_counter() - t_all:.1f} s | {card}")
    return out


def parallel_report(rcs, outputs, card, navppo_check):
    """The ranks' lines relayed and their verdicts asserted -> (launches
    summed over the ranks by kernel, each rank's launches by part)."""
    for r, (code, text) in enumerate(zip(rcs, outputs)):
        for line in text.splitlines():
            if not line.startswith(("PAR_RANK ", "PAR_SUMMARY ")):
                log(f"  [rank {r}] {line}")
        if code != 0:
            raise AssertionError(f"parallel: rank {r} exited {code}")
    ranks = [json.loads(next(x for x in text.splitlines() if x.startswith("PAR_RANK "))[9:])
             for text in outputs]
    summary = json.loads(next(x for x in outputs[0].splitlines()
                              if x.startswith("PAR_SUMMARY "))[12:])
    log(f"parallel: backend {summary['backend']} ({PAR_RANKS} processes on one card); a global "
        f"sum over the ranks {summary['a_global_sum']:.0f}")
    steps = PAR_NAV_ITERATIONS * int(NAVPPO_ARGS[NAVPPO_ARGS.index("--horizon") + 1])
    for r in ranks:
        lb, lc, le = r["launches"]["b navppo"], r["launches"]["c lidarnav"], r["launches"]["e tp_vit"]
        log(f"parallel: rank {r['rank']} launches: navppo K1 {lb['raycast_depth']} K5 "
            f"{lb['attention_fwd']}, lidarnav K1 {lc['raycast_depth']}, tensor-parallel ViT K5 "
            f"{le['attention_fwd']}; seconds "
            + ", ".join(f"{k} {v:.1f}" for k, v in r["seconds"].items()))
        log(f"parallel: rank {r['rank']} memory on its allocator (GB, peak / held after): "
            + ", ".join(f"{k} {v:.3f}" if v is not None else f"{k} not measured"
                        for k, v in r["memory_gb"].items())
            + f" | {card}")
        want = {"b navppo": {"raycast_depth": steps, "attention_fwd": 4 * steps},
                "c lidarnav": {"raycast_depth": PAR_LIDAR_HORIZON, "attention_fwd": 0},
                "e tp_vit": {"raycast_depth": 0, "attention_fwd": 4}}
        for part, kernels in want.items():
            got = r["launches"][part]
            if any(got[k] != kernels.get(k, 0) for k in got):
                raise AssertionError(f"parallel: rank {r['rank']} {part} launches {got}, "
                                     f"expected {kernels} and no other kernel")
    one_rank = navppo_check.get("s_per_iteration") if navppo_check else None
    log(f"parallel: b each rank built at its block ({NAV_ENVS // PAR_RANKS} of {NAV_ENVS} "
        f"envs): carry, observation, scene tables and generators bit-equal to the "
        f"build-then-cut rank {summary['b_block_equals_cut']}; f population members built on "
        f"rank 0: {summary['f_members_built']} of {PAR_POP['num_seeds']} | {card}")
    log(f"parallel: b navppo {NAV_ENVS} envs over {PAR_RANKS} ranks: s/iteration "
        + ", ".join(f"{x:.3f}" for x in summary["b_s_per_iteration"])
        + (" (phase 9, one rank, this run: " + ", ".join(f"{x:.3f}" for x in one_rank) + ")"
           if one_rank else "")
        + f", reward {summary['b_reward']}; learner identical across ranks "
        f"{summary['b_learner_identical']}; {PAR_DRAW_STEPS} steps against one rank: depth "
        f"images bit-equal {summary['b_depth_bit_equal']}, the observations' state columns "
        f"bit-equal {summary['b_obs_state_bit_equal']}, their bf16 ViT latents within "
        f"{summary['b_latent_max_err']:.3g} (bar {PAR_LATENT_TOL}) | {card}")
    log(f"parallel: c lidarnav 2 x {PAR_LIDAR_ENVS // 2} envs, learner identical "
        f"{summary['c_learner_identical']}; d checkpoint {summary['d_checkpoint_mb']:.2f} MB from "
        f"2 ranks into 1: learner bit-equal {summary['d_learner_bit_equal']}, carry equal "
        f"{summary['d_carry_equal']}; e tensor-parallel ViT ({summary['e_heads_per_rank']} heads a "
        f"rank, batch {PAR_TP_BATCH}, f32) max err {summary['e_max_err']:.3g} (bar {PAR_TP_TOL}), "
        f"{summary['e_ms']['tensor_parallel']:.1f} ms against {summary['e_ms']['whole']:.1f} ms "
        f"whole; f population {PAR_POP['num_seeds']} x {PAR_POP['num_envs']} (members "
        f"{summary['f_local_members']} on rank 0) bit-equal to the unsharded one "
        f"{summary['f_members_bit_equal']}, {summary['f_env_steps_per_s']:.1f} env-steps/s | {card}")
    g = summary["g"]
    log(f"parallel: g the rehearsals' legs in the ranks' processes (position PPO, horizon "
        f"{PAR_REHEARSAL['horizon']}, {PAR_REHEARSAL['timed_iters']} timed iterations; the ranks "
        f"share one card: harness checks, not efficiencies): {PAR_RANKS} ranks x "
        f"{g['envs_per_process']} envs {g['two_ranks']:.1f} env-steps/s; one rank "
        f"{g['envs_per_process']} envs {g['one_rank_weak']:.1f} (weak ratio "
        f"{g['two_ranks'] / (PAR_RANKS * g['one_rank_weak']):.4f}), one rank "
        f"{PAR_RANKS * g['envs_per_process']} envs {g['one_rank_strong']:.1f} (strong ratio "
        f"{g['two_ranks'] / g['one_rank_strong']:.4f}) | {card}")
    checks = {"b_block_equals_cut": summary["b_block_equals_cut"],
              "f_only_local_members_built": summary["f_members_built"]
              == PAR_POP["num_seeds"] // PAR_RANKS,
              "b_learner_identical": summary["b_learner_identical"],
              "b_depth_bit_equal": summary["b_depth_bit_equal"],
              "b_obs_state_bit_equal": summary["b_obs_state_bit_equal"],
              "b_latents_close": summary["b_latents_close"],
              "c_learner_identical": summary["c_learner_identical"],
              "d_learner_bit_equal": summary["d_learner_bit_equal"],
              "d_carry_equal": summary["d_carry_equal"],
              "e_tp": summary["e_max_err"] <= PAR_TP_TOL and summary["e_heads_per_rank"] == 4,
              "f_members_bit_equal": summary["f_members_bit_equal"],
              "g_rates": all(g[k] > 0 for k in ("two_ranks", "one_rank_weak",
                                                 "one_rank_strong"))}
    if not all(checks.values()):
        raise AssertionError(f"parallel: failed {[k for k, v in checks.items() if not v]}")
    totals = {}
    for r in ranks:
        for part in r["launches"].values():
            for k, v in part.items():
                totals[k] = totals.get(k, 0) + v
    return totals, [r["launches"] for r in ranks]


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-attention", metavar="FILE",
                    help="another attention.cu (the parent commit's): its bf16 serving kernel "
                         "is built beside the shipped one and timed with it in turns")
    # phase 16 starts this script again as each of its ranks
    ap.add_argument("--parallel-rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--work", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--card", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    if args.parallel_rank is not None:
        return par_rank_main(args.parallel_rank, args.coordinator, args.work, args.card)
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

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 13 articulated")
    # 13. the articulated robots and their tasks (no kernel), the solver on
    #     the card against the CPU, the IMU (K2 in the camera run), the
    #     sensor catalog (K2, and K1 for the sensors without segmentation)
    art_launches, k2_catalog, k1_catalog = articulated_phase(torch, port, rc, ac, card)
    for rec, name, sub in ((records[0], "raycast_depth", k1_catalog),
                           (records[1], "raycast_seg", k2_catalog)):
        rec["launches"] += art_launches[name]
        rec["launches_articulated_path"] = art_launches[name]
        rec[f"catalog_at_{CATALOG_ENVS}_envs"] = sub
        rec["max_abs_err"] = max([rec["max_abs_err"]] + [r["max_abs_err"] for r in sub.values()])

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 14 scenes")
    # 14. the forest and dynamic scenes (K2, K1), stereo (K2 + K1) and the
    #     twin cameras (K2), the mesh scene (K1-K4), the native loader
    scene_launches, scene_tables = scenes_phase(torch, port, rc, card)
    for rec in records[:2] + mode_records:
        name = rec["name"]
        rec["launches"] += scene_launches[name]
        rec["launches_scenes_path"] = scene_launches[name]
        rec.update(scene_tables[name])
        rec["max_abs_err"] = max([rec["max_abs_err"]] + [
            r["max_abs_err"] for r in scene_tables[name].values()])

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 15 differentiable")
    # 15. differentiable training: the ray cast's gradient and inverse
    #     rendering (K1 forward, the oracle's backward), rollout gradients,
    #     BPTT and the PPO population with PBT (no kernel)
    diff_launches, k1_diff = differentiable_phase(torch, port, rc, card)
    records[0]["launches"] += diff_launches["raycast_depth"]
    records[0]["launches_differentiable_path"] = diff_launches["raycast_depth"]
    records[0][f"at_{DIFF_ENVS}x{135 * 240}_differentiable"] = k1_diff
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], k1_diff["max_abs_err"])

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 16 parallel")
    # 16. multi-process training: two ranks on the card, K1 and K5 in each
    #     rank's rollout and in the tensor-parallel ViT
    par_totals, par_per_rank = parallel_phase(torch, rc, ac, card, navppo_check)
    for rec, name in ((records[0], "raycast_depth"), (records[2], "attention_fwd")):
        rec["launches"] += par_totals[name]
        rec["launches_parallel_path"] = par_totals[name]
        rec["launches_parallel_path_per_rank"] = [
            {part: c[name] for part, c in r.items()} for r in par_per_rank]

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 17 deploy")
    # 17. deployment and the viewers: the offline viewer's K2 on one env's
    #     chase grid, the live and web viewers, the deploy chain, the
    #     navigation interface (K1 each step) and the ROS node's loopback
    dep_totals, dep_parts, k2_viewer, dep_checks = deployment_phase(torch, port, rc, ac, card)
    for rec, name in ((records[0], "raycast_depth"), (records[1], "raycast_seg")):
        rec["launches"] += dep_totals[name]
        rec["launches_deploy_path"] = dep_totals[name]
    records[1][f"at_1x{VIEWER_SIZE[0] * VIEWER_SIZE[1]}_viewer"] = k2_viewer
    records[1]["launches_deploy_path_by_part"] = {k: v["raycast_seg"] for k, v in dep_parts.items()}
    records[1]["max_abs_err"] = max(records[1]["max_abs_err"], k2_viewer["max_abs_err"])
    records[0]["deploy_checks"] = dep_checks

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: phase 18 tools")
    # 18. the utilities and the capability examples: the profiler on the
    #     state step, one PPO iteration and the navigation step (K1, K5),
    #     then NeuroBEM, the sys-id tools and the gradient examples
    tools_launches, tools_numbers = tools_phase(torch, port, rc, ac, card)
    for rec, name in ((records[0], "raycast_depth"), (records[2], "attention_fwd")):
        rec["launches"] += tools_launches[name]
        rec["launches_tools_path"] = tools_launches[name]
    records[0]["tools_profile"] = tools_numbers["profile"]

    log(f"elapsed {time.perf_counter() - t_run:.1f} s: all phases")
    log(json.dumps({"kernels": records + mode_records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
