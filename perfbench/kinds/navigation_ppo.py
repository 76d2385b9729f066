"""Kind ``navigation_ppo``: the upstream navigation training recipe, trained
the way rl-games' multi-GPU mode runs it, one process per card, each running
the YAML as written.

Every rank builds its trainer as a user does: ``load_yaml_config`` of the
port's copy of the recipe, ``ppo_config_from_yaml(..., world=W)``,
``make_task(..., shard=env_block(N))`` and ``PPOTrainer``, in a process
group joined by ``initialize_multihost`` (NCCL on the card, gloo on the
CPU). Rank 0 is this process, whose clock and CUDA events are the
harness's; ranks 1..W-1 are spawned at set-up (``python3 -m
perfbench.kinds.navigation_ppo <run dir> <rank>``), each with a deadline and
killed by its own PID past it, and each leaving when this process is gone.

A step is one iteration of every rank: a rollout of ``horizon_length``
env steps (``PPOTrainer.rollout_step``) and ``PPOTrainer.update`` on it, so
the window ends on an iteration's end and ``step_ms_p95`` reads whole
iterations, the update with them. Rank 0 opens each iteration with a
message on a TCP store of its own, which the others wait for before they
start it: whether to capture its update, which steps to profile, or that the
run is over. So the ranks make the same collectives however rank 0's window
ends. No message makes the device wait. At the end every rank meets at a
barrier whose token is read back (``parallel.mesh.barrier``) and then tears
down its communicators, since NCCL destroys them on every rank together.

Captured on rank 0 at one env step of each capture iteration (its index in
the rollout drawn from the seed): the sim state before and after the
step and the generator's state, the sampled action, the crash verdicts, the
depth image of the compared envs (the navigation task module's
``render_camera`` is wrapped, as kind ``navigation_policy`` does), the
latents, and the recurrent policy's inputs and outputs (a forward hook for
that step only) with the parameters in use. Captured on every rank at the
first update that starts in the window after warm-up: its rollout, the
observation and hidden state after it; on rank 0 also the learner before
the update (parameters, Adam, learning rate, moments, the generator that
draws the minibatches), the advantages and normalised returns it made, and
the parameters after its first optimizer step. The other ranks' captures
reach rank 0 as files after the window.

Compared (``Check``): the physics, crashes, depth and latents as in
``nav_vit.serve.4k``, with the task's draws replayed at the global env count
(a sharded generator draws every env and keeps its block); ``policy_gap``,
the policy's mean, value and new hidden state against the reference from the
same inputs; ``advantage_gap``, rank 0's advantages and normalised returns
against the reference's GAE and value normalisation on every rank's
rollout; ``update_gap``, rank 0's parameter change in the first optimizer
step against the reference's one step on the whole global minibatch.
"""

from __future__ import annotations

import atexit
import dataclasses
import inspect
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch

from ..counts import raycast as rc
from ..counts import recurrent_ppo as pc
from ..counts import vit as vc
from ..counts.peaks import PEAK_BF16_FLOPS, PEAK_F32_FLOPS
from ..harness import checks
from ..harness.core import Refused
from ..harness.port import (attention_launches, port_seed, raycast_launches, scene_tables,
                            small_camera, state_dict)
from ..harness.tracing import Slice, Spans
from ..reference import navigation as nav_ref
from ..reference import recurrent_ppo as ppo_ref
from ..reference.networks import ViTReference
from ..reference.physics import Physics, env_step
from ..reference.raycast import Camera, prim_counts, render, sensor_pose, world_prims

ROOT = Path(__file__).resolve().parents[2]
LATENTS_AT = 17                 # the observation's layout: 17 task numbers, then the latents
STORE_TIMEOUT_S = 600           # the longest a rank waits for a message
DEADLINE_S = 1800               # past this the spawned ranks are killed
ROLLOUT = ("norm_obs", "actions", "logps", "values", "rewards", "dones", "done_prev", "h0")


def _port_has_recipe() -> bool:
    """The port builds the recipe: the GRU's LayerNorm option and the
    runner's per-rank minibatch."""
    from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig
    from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner
    return ("rnn_layer_norm" in {f.name for f in dataclasses.fields(PPOConfig)}
            and "world" in inspect.signature(runner.ppo_config_from_yaml).parameters)


def _params(network):
    return {k: v.detach().clone() for k, v in network.named_parameters()}


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _expect(cfg, ppo, rnn_units):
    """The configuration file's recipe against the PPOConfig the port made
    of the YAML: a mismatch raises, naming each key."""
    c, net = cfg["ppo"], cfg["network"]
    want = dict(horizon=c["horizon_length"], epochs=c["mini_epochs"], gamma=c["gamma"],
                gae_lambda=c["tau"], clip_eps=c["e_clip"], value_coef=c["critic_coef"],
                entropy_coef=c["entropy_coef"], lr=c["learning_rate"], lr_schedule=c["lr_schedule"],
                kl_threshold=c["kl_threshold"], min_lr=c["min_lr"], max_lr=c["max_lr"],
                max_grad_norm=c["grad_norm"], normalize_obs=c["normalize_input"],
                normalize_value=c["normalize_value"], normalize_advantage=c["normalize_advantage"],
                value_bootstrap=c["value_bootstrap"], bounds_loss_coef=c["bounds_loss_coef"],
                reward_scale=c["reward_scale"], hidden=tuple(net["mlp"]),
                activation=net["activation"], rnn=net["rnn"], rnn_hidden=rnn_units,
                rnn_layer_norm=net["layer_norm"])
    bad = {k: (getattr(ppo, k), v) for k, v in want.items() if getattr(ppo, k) != v}
    if bad:
        raise ValueError(f"the recipe the port read differs from {cfg['name']}.json: {bad}")


class Rank:
    """One rank of the run: the process group, the trainer, the steps, the
    iteration messages and the update's capture."""

    def __init__(self, cfg, traffic, device, seed, overrides, rank, world, ports):
        import aerial_gym_simulator_tpu_torch as port
        from aerial_gym_simulator_tpu_torch.parallel.distributed import (env_block,
                                                                         initialize_multihost)
        from aerial_gym_simulator_tpu_torch.rl.ppo import PPOTrainer
        from aerial_gym_simulator_tpu_torch.rl_training.rl_games.runner import (
            load_yaml_config, ppo_config_from_yaml)
        self.rank, self.world, self.device = rank, world, device
        self.store = torch.distributed.TCPStore("127.0.0.1", ports[1], world, rank == 0,
                                                timedelta(seconds=STORE_TIMEOUT_S),
                                                wait_for_workers=False)
        initialize_multihost(f"127.0.0.1:{ports[0]}", world, rank, require=True,
                             backend="nccl" if device.type == "cuda" else "gloo")
        self.n_local = int(overrides.get("envs", traffic["envs_per_rank"]))
        self.n_global = world * self.n_local
        doc = load_yaml_config(str(ROOT / cfg["recipe"]))
        if "minibatch" in overrides:          # tests: one rank's minibatch at their size
            doc["params"]["config"]["minibatch_size"] = int(overrides["minibatch"])
        units = int(doc["params"]["network"]["rnn"]["units"])
        self.ppo_cfg = ppo_config_from_yaml(doc, num_envs=self.n_global, seed=port_seed(seed),
                                            world=world)
        _expect(cfg, self.ppo_cfg, units)
        task_cfg = dataclasses.replace(port.task_registry.get_task_config(cfg["task"]),
                                       vae_params_path=str(ROOT / cfg["encoder"]))
        self.task = port.task_registry.make_task(cfg["task"], num_envs=self.n_global,
                                                 seed=port_seed(seed), task_config=task_cfg,
                                                 device=str(device),
                                                 shard=env_block(self.n_global))
        if "camera_hw" in overrides:
            self.task.params = small_camera(self.task.params, overrides["camera_hw"], device)
            self.task.sim_env.params = self.task.params
        self.trainer = PPOTrainer(self.task, self.ppo_cfg)
        self.H = self.ppo_cfg.horizon
        self.t = 0                  # steps every rank has run
        self.traj = None
        self.capture = False        # this iteration's update is captured
        self.update_cap = None
        self.profile = None         # (first, end) steps profiled on this rank
        self._slice = None

    def message(self, msg=None):
        """At an iteration's first step: rank 0 posts ``msg``, the others wait
        for it (and post their peak memory) -> the message."""
        key = f"chunk{self.t // self.H}"
        if self.rank == 0:
            self.store.set(key, json.dumps(msg))
            return msg
        msg = json.loads(self.store.get(key))
        if self.device.type == "cuda":
            self.store.set(f"peak{self.rank}",
                           str(torch.cuda.max_memory_allocated(self.device)))
        if not msg["stop"]:
            self.capture = msg["capture"]
            self.profile = msg["profile"] or self.profile
        return msg

    def rollout_step(self):
        tr = self.trainer
        if self.t % self.H == 0:
            self.h0, self.traj = tr.env_carry[1], []
        if self.profile is not None and self.t == self.profile[0]:
            self._slice = Slice(Spans(self.device))
            self._slice.start()
        out = tr.rollout_step()
        self.traj.append(out)
        self.t += 1
        return out

    @property
    def rollout_done(self) -> bool:
        return self.t % self.H == 0

    def update(self):
        from aerial_gym_simulator_tpu_torch.rl.ppo import make_rollout
        ro = make_rollout(self.traj, self.h0)
        self.traj = None
        if self.capture:
            self._arm_capture(ro)
        self.trainer.update(ro)
        self.capture = False

    def end_step(self):
        """After a step's work: the profiled slice ends on the others."""
        if self._slice is not None and self.t == self.profile[1]:
            self._slice.stop()
            tr = self._slice.read()
            self._slice = None
            self.store.set(f"busy{self.rank}", json.dumps(dict(busy_s=tr.busy_s,
                                                               window_s=tr.window_s)))

    def _arm_capture(self, ro):
        """Record the update's inputs and, through its first optimizer
        step, what it made (the trainer's own methods, wrapped for this
        update alone)."""
        tr = self.trainer
        _, h, done = tr.env_carry
        cap = self.update_cap = dict(rollout={k: getattr(ro, k) for k in ROLLOUT},
                                     obs_last=tr.obs, h_last=h, done_last=done)
        if self.rank != 0:
            return
        cap["norm"] = {k: v.clone() for k, v in tr.norm.items()}
        a = tr.obs_dim + tr.action_dim
        update_rnn, step = tr._update_rnn, tr._step

        def first_step(total, stats):
            del tr._step
            out = step(total, stats)
            cap["after"] = _params(tr.network)
            return out

        def rows_in(rows, h0):
            del tr._update_rnn
            names = [k for k, _ in tr.network.named_parameters()]
            cap.update(adv=rows[..., a + 2].clone(), ret=rows[..., a + 3].clone(),
                       params=_params(tr.network), lr=tr.lr.clone(),
                       gen=tr.generator.get_state(),
                       adam={names[i]: {k: v.clone() for k, v in st.items()}
                             for i, st in tr._adam_state().items()})
            tr._step = first_step
            return update_rnn(rows, h0)

        tr._update_rnn = rows_in

    def close(self):
        """Every rank meets at a barrier read back on the host, then tears
        down its communicators (NCCL destroys them on every rank together).
        A world of one has no shard and nobody to wait for."""
        from aerial_gym_simulator_tpu_torch.parallel import mesh
        shard = self.trainer.shard
        self.task = self.trainer = None
        if torch.distributed.is_initialized():
            if shard is not None:
                mesh.barrier(shard, self.device)
            torch.distributed.destroy_process_group()


class Loop:
    def __init__(self, cfg, traffic, device, seed, overrides):
        if not _port_has_recipe():
            raise Refused("the port cannot build the recipe: no PPOConfig.rnn_layer_norm or "
                          "no ppo_config_from_yaml(world=)")
        import aerial_gym_simulator_tpu_torch.tasks.navigation_task as nav
        from aerial_gym_simulator_tpu_torch.parallel.multiproc import free_port, worker_env
        self.cfg = cfg
        self.world = int(overrides.get("ranks", traffic["ranks"]))
        self.k = int(traffic["trace"]["steps"])             # iterations
        self.warmup = int(traffic["warmup_steps"])           # iterations
        self._within = np.random.default_rng([seed, 1])      # a capture's env step
        if device.type == "cuda":
            from aerial_gym_simulator_tpu_torch.ops._build import build_all
            build_all(self.libraries())       # before the other ranks look for them
            device = torch.device("cuda", 0)
        self.device = device
        self.dir = tempfile.mkdtemp(prefix="perfbench_ppo_")
        ports = (free_port(), free_port())
        with open(os.path.join(self.dir, "spec.json"), "w") as f:
            json.dump(dict(cfg=cfg, traffic=traffic, overrides=overrides, seed=seed,
                           device=device.type, world=self.world, ports=ports), f)
        env = worker_env()
        self.procs, self.logs = [], []
        for r in range(1, self.world):
            log = open(os.path.join(self.dir, f"rank{r}.log"), "w")
            self.logs.append(log)
            self.procs.append(subprocess.Popen(
                [sys.executable, "-m", "perfbench.kinds.navigation_ppo", self.dir, str(r)],
                cwd=str(ROOT), env=env, stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT))
        self._done = threading.Event()
        threading.Thread(target=self._deadline, daemon=True).start()
        atexit.register(self._kill)
        self.rank = Rank(cfg, traffic, device, seed, overrides, 0, self.world, ports)
        self.num_envs = self.rank.n_local          # the compared rows are rank 0's
        self.work = {"env_steps": self.rank.n_global * self.rank.H}
        self.captured = False
        self.profile = None
        self._nav = nav
        self._render = nav.render_camera
        self._pixels, self._want_pixels = None, False

        def render_camera(*args, **kwargs):
            out = self._render(*args, **kwargs)
            if self._want_pixels:
                self._pixels = out[0]
            return out

        nav.render_camera = render_camera

    # -- the other ranks ----------------------------------------------------------------

    def _deadline(self):
        if not self._done.wait(DEADLINE_S):
            self._kill()

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.wait()

    def _log_tail(self, r):
        with open(os.path.join(self.dir, f"rank{r}.log")) as f:
            return f.read()[-4000:]

    # -- the harness's interface -----------------------------------------------------

    def libraries(self):
        from aerial_gym_simulator_tpu_torch.ops import attention_cuda, raycast_cuda
        return [raycast_cuda.LIBRARY, attention_cuda.LIBRARY]

    def launches(self):
        from aerial_gym_simulator_tpu_torch.rl.ppo import COUNTS
        return {**raycast_launches(), **attention_launches(),
                **{f"ppo.{k}": v for k, v in COUNTS.items()}}

    def step(self, i, spans, cap=None):
        """One iteration of every rank: the rollout, then its update."""
        r = self.rank
        if spans.timing and self.profile is None:
            # the harness times K iterations, then profiles the next K (in
            # env steps on the other ranks)
            self.profile = [r.t + self.k * r.H, r.t + 2 * self.k * r.H]
        capture = not self.captured and i >= 0 and r.t >= self.warmup * r.H
        self.captured |= capture
        r.capture = capture
        r.message(dict(stop=False, capture=capture, profile=self.profile))
        at = int(self._within.integers(r.H)) if cap is not None else -1
        for j in range(r.H):
            with spans("rollout"):
                if j == at:
                    self._captured_step(cap)
                else:
                    r.rollout_step()
        with spans("update"):
            r.update()

    def _captured_step(self, cap):
        r, tr = self.rank, self.rank.trainer
        rows = cap["rows"]
        ns = tr.env_carry[0]
        cap.update(before=state_dict(ns.sim), rng=ns.sim.rng.get_state(),
                   params=_params(tr.network),
                   shard=(r.rank * r.n_local, r.n_local, r.n_global))

        def hook(module, args, out):
            cap["policy_in"] = tuple(x.index_select(0, rows) for x in args)
            cap["policy_out"] = (out[0].index_select(0, rows), out[2].index_select(0, rows),
                                 out[3].index_select(0, rows))

        handle = tr.network.register_forward_hook(hook)
        self._want_pixels = True
        try:
            out = r.rollout_step()
        finally:
            handle.remove()
            self._want_pixels = False
        cap.update(action=out[1], after=state_dict(tr.env_carry[0].sim), obs_after=tr.obs,
                   term=out[6], done=out[5], depth=self._pixels.index_select(0, rows))
        self._pixels = None

    def bound_inputs(self):
        return state_dict(self.rank.trainer.env_carry[0].sim)

    def bounds(self, state, device):
        """Least time of an iteration's counted work on one card (seconds):
        per rollout step the ray cast's on the render's poses and tables,
        the ViT's products at the bf16 peak and the policy's forward at the
        f32 peak; then the update's products at the f32 peak."""
        cfg, n = self.cfg, self.rank.n_local
        cam = Camera(cfg["camera"], device)
        scene = self.rank.task.params.scene
        with torch.no_grad():
            origin, quat = sensor_pose(cam, state["pos"], state["quat"], state["cam_mount_pos"],
                                       state["cam_mount_quat"])
            prims = world_prims(scene_tables(scene), state["obstacle_pos"],
                                state["obstacle_quat"])
            pose = torch.cat([origin, quat, torch.zeros_like(origin[:, :1])], dim=-1)
            ray_s, by, _ = rc.least_time_s(pose, prims, cam.dirs, prim_counts(scene_tables(scene)),
                                           cam.max_range, "depth")
        enc, c, net = cfg["encoder_shape"], cfg["ppo"], cfg["network"]
        vit = vc.vit_flops_per_image(enc["tokens"], enc["patch"][0] * enc["patch"][1],
                                     enc["dim"], enc["depth"], enc["latent_dim"])
        per_env = pc.policy_flops(cfg["obs_dim"], net["mlp"], net["units"], cfg["action_dim"])
        H = c["horizon_length"]
        update = pc.update_flops(per_env, n * H, c["mini_epochs"], n)
        return dict(raycast_s=ray_s, raycast_by=by,
                    counted_s=(H * (ray_s + n * vit / PEAK_BF16_FLOPS
                                    + n * per_env / PEAK_F32_FLOPS)
                               + update / PEAK_F32_FLOPS))

    def peak_bytes(self):
        if self.device.type != "cuda":
            return 0
        peaks = [torch.cuda.max_memory_allocated(self.device)]
        peaks += [int(self.rank.store.get(f"peak{r}")) for r in range(1, self.world)]
        return max(peaks)

    def busy_s(self, trace):
        busy = [trace.busy_s]
        busy += [json.loads(self.rank.store.get(f"busy{r}"))["busy_s"]
                 for r in range(1, self.world)]
        return sum(busy) / len(busy)

    def close(self):
        """Runs iterations until one update is captured (a short run's
        first after warm-up), stops the other ranks, gathers their
        captures, restores the task module."""
        r = self.rank
        spans = Spans(self.device)
        i = 0
        while r.update_cap is None:
            self.step(i, spans)
            i += 1
        r.message(dict(stop=True))
        self._nav.render_camera = self._render
        files = [os.path.join(self.dir, f"rank{n}.pt") for n in range(1, self.world)]
        deadline = time.monotonic() + 300
        for n, (p, f) in enumerate(zip(self.procs, files), 1):
            while not os.path.exists(f):
                if p.poll() is not None or time.monotonic() > deadline:
                    self._kill()
                    raise RuntimeError(f"rank {n} left no capture (exit {p.poll()}):\n"
                                       f"{self._log_tail(n)}")
                time.sleep(0.1)
        caps = [r.update_cap] + [_to(torch.load(f), self.device) for f in files]
        kept = dict(scene=scene_tables(r.task.params.scene), updates=caps,
                    n_local=r.n_local)
        r.close()
        self.rank = None
        for n, p in enumerate(self.procs, 1):
            try:
                code = p.wait(timeout=max(deadline - time.monotonic(), 10))
            except subprocess.TimeoutExpired:
                code = None
            if code != 0:
                self._kill()
                raise RuntimeError(f"rank {n} ended with {code}:\n{self._log_tail(n)}")
        self._done.set()
        for log in self.logs:
            log.close()
        shutil.rmtree(self.dir, ignore_errors=True)
        return kept


class Check:
    def __init__(self, cfg, traffic, device, overrides, kept):
        ppo_ref.no_tf32()
        self.device = torch.device("cuda", 0) if device.type == "cuda" else device
        self.cfg, self.scene = cfg, kept["scene"]
        self.updates, self.n_local = kept["updates"], kept["n_local"]
        self.cam_cfg = dict(cfg["camera"])
        if "camera_hw" in overrides:
            self.cam_cfg.update(height=overrides["camera_hw"][0], width=overrides["camera_hw"][1])
        self.vit = ViTReference(str(ROOT / cfg["encoder"]), self.device)
        c = cfg["ppo"]
        self.ref_cfg = dict(e_clip=c["e_clip"], critic_coef=c["critic_coef"],
                            entropy_coef=c["entropy_coef"], bounds_loss_coef=c["bounds_loss_coef"],
                            grad_norm=c["grad_norm"], kl_threshold=c["kl_threshold"],
                            min_lr=c["min_lr"], max_lr=c["max_lr"], gamma=c["gamma"], tau=c["tau"],
                            obs_dim=cfg["obs_dim"], action_dim=cfg["action_dim"])
        # the global minibatch: every rank's minibatch_size of the recipe, in
        # whole sequences
        world = len(self.updates)
        per_rank = int(overrides.get("minibatch", c["minibatch_size"]))
        self.mb_envs = min(world * per_rank // c["horizon_length"], world * self.n_local)
        self._update = {}

    def _update_numbers(self, precision):
        """The reference's update on every rank's rollout -> rank 0's
        advantages and normalised returns (N_local, T) and the change of
        the parameters in the first optimizer step."""
        if precision not in self._update:
            quant = "bf16" if precision == "control" else None
            u0 = self.updates[0]
            ro = {k: torch.cat([u["rollout"][k] for u in self.updates], dim=1)
                  for k in ROLLOUT if k != "h0"}
            last = {k: torch.cat([u[f"{k}_last"] for u in self.updates], dim=0)
                    for k in ("obs", "h", "done")}
            h0 = torch.cat([u["rollout"]["h0"] for u in self.updates], dim=0)
            rows, adv, ret = ppo_ref.update_rows(u0["params"], u0["norm"], ro, last,
                                                 self.ref_cfg, quant)
            g = torch.Generator(device=self.device)
            g.set_state(u0["gen"])
            idx = torch.randperm(rows.shape[0], generator=g, device=self.device)[:self.mb_envs]
            mb = ppo_ref.split_rows(rows.index_select(0, idx), self.cfg["obs_dim"],
                                    self.cfg["action_dim"])
            with torch.enable_grad():          # the harness compares under no_grad
                new, _, _ = ppo_ref.optimizer_step(u0["params"], u0["adam"], float(u0["lr"]),
                                                   self.ref_cfg, mb, h0.index_select(0, idx),
                                                   quant)
            n = self.n_local
            self._update[precision] = dict(
                adv=adv[:, :n].transpose(0, 1), ret=ret[:, :n].transpose(0, 1),
                change={k: new[k] - u0["params"][k] for k in new})
        return self._update[precision]

    def program(self, cap):
        lat = self.cfg["task_params"]["latent_dim"]
        u0 = self.updates[0]
        obs = cap["obs_after"].index_select(0, cap["rows"])
        return dict(stepped=dict(cap["after"], crashes=cap["term"]), depth=cap["depth"],
                    latents=obs[:, LATENTS_AT:LATENTS_AT + lat],
                    policy=cap["policy_out"],
                    update=dict(adv=u0["adv"], ret=u0["ret"],
                                change={k: u0["after"][k] - u0["params"][k] for k in u0["params"]}))

    def reference(self, cap, precision=None):
        """At the configuration's precision (float32 physics, ray cast,
        policy and update; float32 networks for the bf16 encoder), or with
        ``precision`` "control" at the next below: bfloat16 physics, ray
        cast, policy and update products, float8 e4m3 encoder products."""
        control = precision == "control"
        dt = torch.bfloat16 if control else torch.float32
        ph = Physics.build(self.cfg["physics"], self.device, dt)
        task, rows = self.cfg["task_params"], cap["rows"]
        offset, n_local, n_global = cap["shard"]
        # a sharded generator draws every env's numbers and keeps its block
        _, noise, dist = nav_ref.replay_draws(cap["rng"], self.device, n_global,
                                              task["latent_dim"], ph.substeps, ph.disturbance)
        block = lambda x: x[offset:offset + n_local]
        command = nav_ref.action_transform(task, cap["action"])
        out = dict(stepped=env_step(ph, cap["before"], command, self.scene,
                                    disturbances=[block(d) for d in dist], dtype=dt))
        depth, _ = render(Camera(self.cam_cfg, self.device, dt), checks.rows(self.scene, rows),
                          checks.rows(cap["after"], rows), want_seg=False)
        out["depth"] = depth
        mean, logvar = self.vit.moments(depth, quant="fp8" if control else None,
                                        image_hw=(self.cfg["camera"]["height"],
                                                  self.cfg["camera"]["width"]))
        out["latents"] = nav_ref.sampled_latent(mean, logvar, block(noise).index_select(0, rows))
        p_mean, _, p_value, p_h = ppo_ref.policy_forward(cap["params"], *cap["policy_in"],
                                                         quant="bf16" if control else None)
        out["policy"] = (p_mean, p_value, p_h)
        out["update"] = self._update_numbers(precision)
        return out

    def compare(self, got, ref, cap):
        # the task resets its done envs with fresh draws: their state is
        # compared only up to the verdict
        keep = cap["done"] <= 0
        g, r = got["stepped"], ref["stepped"]
        gu, ru = got["update"], ref["update"]
        names = sorted(ru["change"])
        return dict(
            state_gap=checks.state_gap(g, r, keep),
            crash_mismatch=checks.count_unequal(g["crashes"], r["crashes"]),
            depth_mismatch_share=checks.depth_mismatch_share(got["depth"], ref["depth"]),
            latent_rel_err=checks.rms_gap_over_rms(got["latents"], ref["latents"]),
            policy_gap=max(checks.max_gap_over_rms(a, b)
                           for a, b in zip(got["policy"], ref["policy"])),
            advantage_gap=max(checks.max_gap_over_rms(gu["adv"], ru["adv"]),
                              checks.max_gap_over_rms(gu["ret"], ru["ret"])),
            update_gap=checks.max_gap_over_rms(
                torch.cat([gu["change"][k].reshape(-1) for k in names]),
                torch.cat([ru["change"][k].reshape(-1) for k in names])))


def _worker(run_dir: str, rank: int) -> int:
    """Ranks 1..W-1: run iterations as rank 0's messages say, then leave the
    update's capture in the run directory."""
    parent = os.getppid()

    def orphaned():
        while True:
            if os.getppid() != parent:
                os._exit(3)
            time.sleep(1.0)

    threading.Thread(target=orphaned, daemon=True).start()
    torch.set_num_threads(1)
    with open(os.path.join(run_dir, "spec.json")) as f:
        spec = json.load(f)
    device = (torch.device("cuda", rank) if spec["device"] == "cuda"
              else torch.device(spec["device"]))
    r = Rank(spec["cfg"], spec["traffic"], device, spec["seed"], spec["overrides"], rank,
             spec["world"], spec["ports"])
    while True:
        if r.t % r.H == 0 and r.message()["stop"]:
            break
        r.rollout_step()
        if r.rollout_done:
            r.update()
        r.end_step()
    path = os.path.join(run_dir, f"rank{rank}.pt")
    torch.save(_to(r.update_cap, "cpu"), path + ".tmp")
    os.replace(path + ".tmp", path)         # rank 0 reads it once it is whole
    r.close()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(sys.argv[1], int(sys.argv[2])))
