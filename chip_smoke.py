#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (written for the H100).

    python3 chip_smoke.py

Phases, each printed on its own line:
  1. build   - compile the ray-cast kernel (csrc/raycast.cu) with nvcc;
  2. device  - the card's name and power limit (nvidia-smi);
  3. kernel  - the kernel in depth (K1) and depth+seg (K2) mode against its
               plain PyTorch version on the card, on the obstacle env at 64
               envs with the full 135x240 camera (after reset and after 20
               steps) and on a seeded synthetic scene with all four
               primitive kinds; depth max-abs-err <= 2e-3, seg agreement
               >= 0.999 on hit pixels, broad phase on == off bit for bit;
  4. slice   - the obstacle env + depth camera at 16384 envs through the
               user entry points: env_step + render_camera(want_seg=False)
               with zero actions (the bench loop), then EnvManager.step +
               render() (segmentation camera); finite outputs, the kernel's
               launch counts from that run, throughput and peak memory;
  5. timing  - each kernel at the main path's shapes against its plain
               version and its least possible time on this card.

Before the last line it prints one JSON object with a record per kernel;
the last line is {"ok": true, "device": {...}}. Any failure raises and the
script exits non-zero without that line. Without CUDA it exits 1 at once.
"""

import json
import subprocess
import sys
import time

DEPTH_ATOL = 2e-3
SEG_AGREE = 0.999
NUM_ENVS = 16384
SOURCE = "aerial_gym_simulator_tpu_torch/csrc/raycast.cu"
REPLACES = "aerial_gym_simulator_tpu/ops/raycast_pallas.py:90"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_F32_FLOPS = 67e12
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import aerial_gym_simulator_tpu_torch as port
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
        camera_ray_dirs, render_camera, sensor_world_pose)
    from aerial_gym_simulator_tpu_torch.sim import dynamics
    dev = torch.device("cuda")
    names = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
             "lee_velocity_control")

    # 1. build
    t0 = time.perf_counter()
    build_log = rc.build()
    log(f"build: {time.perf_counter() - t0:.2f} s ({rc.library_path().name})")
    for line in build_log.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())

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

    for k in rc.LAUNCHES:
        rc.LAUNCHES[k] = 0
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
    def wall_ms(fn, iters=3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / iters * 1e3

    step_ms = wall_ms(lambda: dynamics.env_step(params, env.state, zeros))
    render_ms = wall_ms(lambda: render_camera(params, env.state, want_seg=False))
    log(f"slice: breakdown env_step {step_ms:.2f} ms "
        f"({params.env.substep_mean} substeps), render_camera(depth) {render_ms:.2f} ms | {card}")

    # 5. kernels at the main path's shapes
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
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })

    log(json.dumps({"kernels": records}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
