#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. build   - compile the ray-cast kernel (csrc/raycast.cu) and the fused
               attention kernel (csrc/attention.cu) with nvcc, side by side;
  2. device  - the card's name and power limit (nvidia-smi);
  3. kernel  - the ray cast in depth (K1) and depth+seg (K2) mode against
               its plain PyTorch version on the card, on the obstacle env at
               64 envs with the full 135x240 camera (after reset and after 20
               steps) and on a seeded synthetic scene with all four
               primitive kinds; depth max-abs-err <= 2e-3, seg agreement
               >= 0.999 on hit pixels, broad phase on == off bit for bit.
               The attention forward (K5) against its plain version on
               numpy-seeded q, k, v: f32 at four shapes within atol/rtol
               1e-4, bf16 within 0.05; a non-contiguous input must raise;
  4. slice   - the obstacle env + depth camera at 16384 envs through the
               user entry points: env_step + render_camera(want_seg=False)
               with zero actions (the bench loop), then EnvManager.step +
               render() (segmentation camera); finite outputs, the kernels'
               launch counts from that run, throughput and peak memory;
  5. nav     - the navigation task at 1024 envs (lmf2, 135x240 camera)
               flown closed loop for 300 steps by the shipped ViT encoder
               (dim 256, depth 4, 8 heads, bf16, attention through K5) and
               policy: finite outputs, K1 launched once and K5 four times
               per step, success share above 0.3, throughput, the step's
               split and peak memory; then 50 steps with the shipped conv
               VAE and its policy (no K5 launch);
  6. timing  - each kernel at its main path's shapes against its plain
               version, its least possible time on this card and, for K5,
               torch's scaled_dot_product_attention on the same tensors.

Before the last line it prints one JSON object with a record per kernel;
the last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without that line. Without CUDA it exits 1 at once.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

DEPTH_ATOL = 2e-3
SEG_AGREE = 0.999
NUM_ENVS = 16384
RAYCAST_SOURCE = "aerial_gym_simulator_tpu_torch/csrc/raycast.cu"
RAYCAST_REPLACES = "aerial_gym_simulator_tpu/ops/raycast_pallas.py:90"
ATTENTION_SOURCE = "aerial_gym_simulator_tpu_torch/csrc/attention.cu"
ATTENTION_REPLACES = "aerial_gym_simulator_tpu/ops/attention_pallas.py:153"

NAV_ENVS = 1024
NAV_STEPS = 300
NAV_CONV_STEPS = 50
NAV_SUCCESS_SHARE = 0.3
NETWORKS = Path(__file__).resolve().parent / "examples/dce_rl_navigation/selected_network"
# (B, S, D, heads), dtype name, atol = rtol
ATTENTION_CASES = [
    ((2, 17, 128, 4), "float32", 1e-4),
    ((1, 225, 128, 4), "float32", 1e-4),
    ((3, 128, 256, 8), "float32", 1e-4),
    ((2, 300, 256, 8), "float32", 1e-4),
    ((64, 225, 256, 8), "bfloat16", 0.05),
    ((2, 100, 256, 4), "bfloat16", 0.05),       # head_dim 64
]
ATTENTION_MAIN_SHAPE = (NAV_ENVS, 225, 256, 8)   # the shipped ViT encoder's

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# f32 operations per (ray, primitive) test, counted from csrc/raycast.cu
# (multiplies, adds, divides, square roots, min/max; compares and selects
# not counted), rotation of the ray into the primitive frame included
FLOPS_PER_TEST = {0: 46, 1: 66, 2: 21, 3: 26}
FLOPS_PER_RAY = 24   # world rotation of the ray, miss test, multiplier


def log(*parts):
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def compare(rc, args, counts, n_tri, tag, errs):
    """Kernel (cull on/off) vs plain version on the same inputs, both modes."""
    import torch
    for want_seg, name in ((False, "raycast_depth"), (True, "raycast_seg")):
        d_k, s_k = rc.raycast(*args, *counts, want_seg=want_seg, n_tri=n_tri)
        d_n, s_n = rc.raycast(*args, *counts, want_seg=want_seg, n_tri=n_tri, cull=False)
        d_r, s_r = rc.raycast_reference(*args, *counts, want_seg=want_seg, n_tri=n_tri)
        torch.cuda.synchronize()
        if not torch.isfinite(d_k).all():
            raise AssertionError(f"{tag}/{name}: non-finite depth")
        if not torch.equal(d_k, d_n) or (want_seg and not torch.equal(s_k, s_n)):
            raise AssertionError(f"{tag}/{name}: broad phase on and off differ")
        err = (d_k - d_r).abs().max().item()
        errs[name] = max(errs[name], err)
        line = f"kernel {tag} {name}: max_abs_err={err:.3g}"
        if want_seg:
            hit = s_r != rc.oracle.NO_HIT_SEGMENTATION_VAL
            agree = (s_k[hit] == s_r[hit]).float().mean().item()
            line += f" seg_agree={agree:.6f} hit_px={int(hit.sum())}"
            if agree < SEG_AGREE:
                raise AssertionError(line)
        log(line + " cull_on==off")
        if err > DEPTH_ATOL:
            raise AssertionError(line)
        del d_k, d_n, d_r, s_k, s_n, s_r


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
    R = cam_dirs.shape[0]
    args = (pose.to(device), prims.contiguous().to(device), cam_dirs,
            torch.ones(R, device=device))
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


def bound_ms(torch, rc, pose, prims, dirs, counts, n_tri, max_range, want_seg):
    """Least time for this call's work on the card: the larger of the bytes
    it must move (inputs once, outputs once) over 3.35 TB/s and the f32
    operations of the (ray, primitive) tests the broad phase keeps for this
    data over 67 TFLOP/s."""
    N, R, P = pose.shape[0], dirs.shape[0], prims.shape[1]
    T = -(-R // rc.THREADS)
    rays_per_tile = torch.full((T,), float(rc.THREADS), device=dirs.device)
    rays_per_tile[-1] = R - (T - 1) * rc.THREADS
    kinds = torch.tensor([rc._kind_of(p, *counts) for p in range(P)], device=dirs.device)
    flops_per_prim = torch.tensor([float(FLOPS_PER_TEST[int(k)]) for k in kinds],
                                  device=dirs.device)
    ops = float(FLOPS_PER_RAY) * N * R
    for lo in range(0, N, 512):
        vis = rc.tile_visibility(pose[lo:lo + 512], prims[lo:lo + 512], dirs, *counts,
                                 max_range)                              # (n, T, P)
        ops += float((vis.float() * flops_per_prim).sum(-1).mul(rays_per_tile).sum())
    n_bytes = 4 * (pose.numel() + prims.numel() + dirs.numel() + R + N * R * (2 if want_seg else 1))
    t_ops, t_bytes = ops / PEAK_F32_FLOPS * 1e3, n_bytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), ops


def attention_bound_ms(shape, itemsize):
    """Least time for one attention call: q, k, v in and o out once over
    3.35 TB/s, against the two products' operations (2 x 2 x B x H x S x S
    x head_dim) over the tensor-core peak for bf16, the f32 peak else."""
    B, S, D, H = shape
    n_bytes = 4 * B * S * D * itemsize
    ops = 4.0 * B * H * S * S * (D // H)
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = ops / (PEAK_BF16_FLOPS if itemsize == 2 else PEAK_F32_FLOPS) * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), t_bytes, t_ops


def numpy_qkv(torch, shape, dtype, device, seed=0):
    import numpy as np
    rs = np.random.RandomState(seed)
    return [torch.from_numpy(rs.standard_normal(shape[:3]).astype(np.float32))
            .to(device).to(dtype) for _ in range(3)]


def compare_attention(torch, ac, attention_reference, device):
    """K5 against its plain version on the card; returns the largest error
    seen on the bf16 cases (the main path's type)."""
    worst = 0.0
    for shape, dtype_name, tol in ATTENTION_CASES:
        dtype = getattr(torch, dtype_name)
        q, k, v = numpy_qkv(torch, shape, dtype, device)
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
        if dtype_name == "bfloat16":
            worst = max(worst, err)
    q, k, v = numpy_qkv(torch, (2, 32, 128, 4), torch.float32, device)
    try:
        ac.fused_attention(q.transpose(0, 1), k, v, 4)
    except ValueError:
        log("kernel attention_fwd: non-contiguous input refused")
    else:
        raise AssertionError("attention: a non-contiguous input was accepted")
    return worst


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


def fly(torch, task, policy, steps):
    """Closed loop: policy(obs) -> task.step, outcomes summed on the device."""
    obs, *_ = task.reset()
    totals = torch.zeros(3, device=task.device)
    finite = torch.ones((), dtype=torch.bool, device=task.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        act = policy(obs["observations"])
        obs, rew, term, trunc, info = task.step(act)
        totals += torch.stack([info["successes"].sum(), info["crashes"].sum(),
                               info["timeouts"].sum()])
        finite &= (torch.isfinite(act).all() & torch.isfinite(rew).all()
                   & torch.isfinite(obs["observations"]).all())
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    if not bool(finite):
        raise AssertionError("non-finite action, reward or observation in the nav loop")
    if obs["observations"].shape != (task.num_envs, 81):
        raise AssertionError(f"observation shape {tuple(obs['observations'].shape)}")
    return dt, [float(x) for x in totals]


def nav_phase(torch, port, rc, ac, card):
    """The navigation task at full width through task_registry.make_task,
    flown by the shipped networks. Returns the kernels' launch counts from
    the ViT run and the task (for the timing phase)."""
    from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        render_camera, sensor_world_pose)
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
    log(f"nav: launches {launches}, successes {succ:.0f} crashes {crash:.0f} "
        f"timeouts {timo:.0f} (success share {succ / max(ended, 1.0):.3f}), curriculum level "
        f"{float(task.nav_state.curriculum_level):.0f}, peak memory {peak_gb:.2f} GB")
    want = {"raycast_depth": NAV_STEPS, "raycast_seg": 0, "attention_fwd": 4 * NAV_STEPS}
    if launches != want:
        raise AssertionError(f"nav launches {launches}, expected {want}")
    if not (succ > 0 and succ / max(ended, 1.0) > NAV_SUCCESS_SHARE):
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

    # K1 at this path's shapes against its plain version, on the final state
    sp, sc, st = params.camera, params.scene, ns.sim
    pos_w, quat_w = sensor_world_pose(sp, st, st.cam_mount_pos, st.cam_mount_quat)
    R = sp.height * sp.width
    args = (rc.pack_pose(pos_w, quat_w),
            rc.pack_prims_world(sc, st.obstacle_pos, st.obstacle_quat),
            sp.dirs.reshape(R, 3), sp.depth_multiplier.reshape(R),
            sc.n_box, sc.n_cyl, sc.n_sph, sp.max_range)
    k1_ms = event_ms(torch, lambda: rc.raycast(*args, want_seg=False, n_tri=sc.n_tri), 10)
    d_k, _ = rc.raycast(*args, want_seg=False, n_tri=sc.n_tri)
    d_r, _ = rc.raycast_reference(*args, want_seg=False, n_tri=sc.n_tri)
    torch.cuda.synchronize()
    k1_err = (d_k - d_r).abs().max().item()
    log(f"nav: raycast_depth at this path's shapes ({NAV_ENVS}x{R} rays, {args[1].shape[1]} "
        f"prims, curriculum-culled scene): kernel {k1_ms:.3f} ms, max_abs_err {k1_err:.3g} "
        f"| {card}")
    if k1_err > DEPTH_ATOL:
        raise AssertionError(f"nav raycast_depth max_abs_err {k1_err}")
    del task, parts, pixels, obs, args, d_k, d_r

    # the task's default perception path: the conv VAE and its policy
    conv_task = make("depth_vae.pkl")
    conv_policy = load_policy_npz(str(NETWORKS / "navigation_policy.npz"))
    zero_counts(rc.LAUNCHES, ac.LAUNCHES)
    dt, (succ, crash, timo) = fly(torch, conv_task, conv_policy, NAV_CONV_STEPS)
    conv_launches = {**rc.LAUNCHES, **ac.LAUNCHES}
    log(f"nav: conv VAE loop {NAV_CONV_STEPS * NAV_ENVS / dt:.1f} env-steps/s "
        f"({dt / NAV_CONV_STEPS * 1e3:.2f} ms/step), launches {conv_launches}, "
        f"successes {succ:.0f} crashes {crash:.0f} timeouts {timo:.0f} | {card}")
    want = {"raycast_depth": NAV_CONV_STEPS, "raycast_seg": 0, "attention_fwd": 0}
    if conv_launches != want:
        raise AssertionError(f"conv nav launches {conv_launches}, expected {want}")
    conv_task.close()
    return launches, k1_err


def time_attention(torch, ac, attention_reference, card):
    """K5 at the main path's shape: kernel, plain version, the library's
    fused attention on the same tensors, and the bound."""
    import torch.nn.functional as F
    shape = ATTENTION_MAIN_SHAPE
    B, S, D, H = shape
    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((B, S, D), generator=g, device="cuda").to(torch.bfloat16)
               for _ in range(3))
    heads = lambda x: x.view(B, S, H, D // H).transpose(1, 2)
    run = lambda: ac.fused_attention(q, k, v, H)
    # kernel, library, library, kernel: both see the same card state
    ms_a = event_ms(torch, run, 20)
    lib_a = event_ms(torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k),
                                                                   heads(v)), 20)
    lib_b = event_ms(torch, lambda: F.scaled_dot_product_attention(heads(q), heads(k),
                                                                   heads(v)), 20)
    ms_b = event_ms(torch, run, 20)
    plain_ms = event_ms(torch, lambda: attention_reference(q, k, v, H), 3)
    # the source's other kernel (f32-accurate multiply-adds) on the same tensors
    fma_ms = event_ms(torch, lambda: ac.attention_forward(q, k, v, H, use_mma=False), 3)
    out, ref = run(), attention_reference(q, k, v, H)
    lib = F.scaled_dot_product_attention(heads(q), heads(k), heads(v)).transpose(1, 2)
    torch.cuda.synchronize()
    err = (out.float() - ref.float()).abs().max().item()
    lib_err = (lib.reshape(B, S, D).float() - ref.float()).abs().max().item()
    if err > 0.05:
        raise AssertionError(f"attention at {shape}: max_abs_err {err}")
    b_ms, b_by, t_bytes, t_ops = attention_bound_ms(shape, 2)
    ms, lib_ms = min(ms_a, ms_b), min(lib_a, lib_b)
    log(f"timing attention_fwd {shape} bf16: kernel {ms:.3f} ms ({ms_a:.3f}, {ms_b:.3f}), "
        f"plain {plain_ms:.2f} ms, multiply-add kernel {fma_ms:.2f} ms, "
        f"scaled_dot_product_attention {lib_ms:.3f} ms "
        f"({lib_a:.3f}, {lib_b:.3f}; its max_abs_err {lib_err:.3g}), max_abs_err {err:.3g} | "
        f"bound {b_ms:.3f} ms by {b_by} (bytes {t_bytes:.3f} ms, operations {t_ops:.3f} ms) "
        f"| {card}")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "max_abs_err": err}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.ops import attention_cuda as ac
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    from aerial_gym_simulator_tpu_torch.ops._build import build_all
    from aerial_gym_simulator_tpu_torch.ops.attention import attention_reference
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        camera_ray_dirs, render_camera, sensor_world_pose)
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    dev = torch.device("cuda")
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")

    # 1. build
    t0 = time.perf_counter()
    build_logs = build_all([rc.LIBRARY, ac.LIBRARY])
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"({rc.LIBRARY.path().name}, {ac.LIBRARY.path().name})")
    for name, build_log in build_logs.items():
        for line in build_log.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}:", line.strip())

    # 2. device
    card = card_line()
    log(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda}")

    # 3. kernel vs plain version on the card
    errs = {"raycast_depth": 0.0, "raycast_seg": 0.0}
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
                cam.dirs.reshape(R, 3), cam.depth_multiplier.reshape(R))

    cnt = counts + (sp.max_range,)
    compare(rc, render_args(env.params, env.state), cnt, n_tri, "obstacles64/reset", errs)
    zeros64 = torch.zeros((64, 4), device=dev)
    for _ in range(20):
        env.step(zeros64)
    compare(rc, render_args(env.params, env.state), cnt, n_tri, "obstacles64/step20", errs)
    dirs_full = torch.as_tensor(camera_ray_dirs(135, 240, 87.0)[0].reshape(-1, 3), device=dev)
    syn_args, syn_counts = synthetic_scene(torch, rc, dirs_full, dev)
    compare(rc, syn_args, syn_counts[:3] + (12.0,), syn_counts[3], "synthetic324", errs)
    del env
    errs["attention_fwd"] = compare_attention(torch, ac, attention_reference, dev)

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

    # 6a. the ray cast at this path's shapes, while its env is in memory
    #     (the attention is timed after the nav phase)
    a, mr = render_args(params, env.state), sp.max_range
    sc = params.scene
    counts, n_tri = (sc.n_box, sc.n_cyl, sc.n_sph), sc.n_tri
    del obs, depth
    records = []
    for want_seg, name in ((False, "raycast_depth"), (True, "raycast_seg")):
        call = lambda: rc.raycast(*a, *counts, mr, want_seg=want_seg, n_tri=n_tri)
        ms = event_ms(torch, call, 5)
        d_k, s_k = call()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        d_r, s_r = rc.raycast_reference(*a, *counts, mr, want_seg=want_seg, n_tri=n_tri)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        err = (d_k - d_r).abs()
        errs[name] = max(errs[name], err.max().item())
        line = (f"timing {name} ({NUM_ENVS}x{R} rays, {a[1].shape[1]} prims): kernel {ms:.3f} ms, "
                f"plain {plain_ms:.1f} ms, max_abs_err {err.max().item():.3g}, "
                f"px>2e-3 {int((err > DEPTH_ATOL).sum())}")
        if want_seg:
            hit = s_r != rc.oracle.NO_HIT_SEGMENTATION_VAL
            agree = (s_k[hit] == s_r[hit]).float().mean().item()
            line += f", seg_agree {agree:.7f}"
            if agree < SEG_AGREE:
                raise AssertionError(line)
        if (err > DEPTH_ATOL).float().mean().item() > 1.0 - SEG_AGREE:
            raise AssertionError(line)
        del d_k, s_k, d_r, s_r, err
        b_ms, b_by, ops = bound_ms(torch, rc, *a[:3], counts, n_tri, mr, want_seg)
        log(line + f" | bound {b_ms:.3f} ms by {b_by} ({ops:.4g} f32 ops) | {card}")
        records.append({
            "name": name, "route": "cuda", "source": RAYCAST_SOURCE,
            "replaces": RAYCAST_REPLACES, "launches": launches[name],
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
        })
    del a, env, state, params, zeros
    torch.cuda.empty_cache()

    # 5. the navigation task flown by the shipped networks
    nav_launches, nav_k1_err = nav_phase(torch, port, rc, ac, card)
    records[0]["max_abs_err"] = max(records[0]["max_abs_err"], nav_k1_err)
    records[0]["launches"] += nav_launches["raycast_depth"]
    records[0]["launches_nav_path"] = nav_launches["raycast_depth"]

    # 6b. the attention at the nav path's shapes
    k5 = time_attention(torch, ac, attention_reference, card)
    records.append({
        "name": "attention_fwd", "route": "cuda", "source": ATTENTION_SOURCE,
        "replaces": ATTENTION_REPLACES, "launches": nav_launches["attention_fwd"],
        "max_abs_err": max(errs["attention_fwd"], k5["max_abs_err"]), "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": k5["library_ms"],
    })

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
