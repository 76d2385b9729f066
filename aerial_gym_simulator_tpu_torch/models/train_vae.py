"""Depth-autoencoder training on renders from the simulator itself.

Counterpart of ``aerial_gym_simulator_tpu/models/train_vae.py``: robots are
teleported to random poses in the obstacle environment, the depth camera is
rendered on the device (the ray-cast kernel), and the conv VAE or the ViT
autoencoder takes one Adam step on that batch. No dataset on disk.

    python -m aerial_gym_simulator_tpu_torch.models.train_vae \\
        --arch vit --vit_attn fused --vit_dim 256 --vit_depth 4 --vit_heads 8 \\
        --steps 2000 --batch 64 --out depth_vit_params.pkl

The checkpoint it writes is the JAX package's own (``sim/convert.
save_model_pickle``): use it through ``NavigationTaskConfig.vae_params_path``
in either package. Weights and compute are f32, as in the JAX package; the
frozen encoder is cast to bf16 only where it is served.

Flags are the JAX script's, except: ``--device`` takes the place of
``--cpu`` (the default is CUDA), ``--vit_attn flash`` runs the fused
kernels in f32 (the JAX package's flash path runs its library kernel in
f32), and ``--log_every`` is new. ``--collision_targets`` renders the
targets from the inflated scene (``utils/collision_image_generator``):
one more launch of the ray-cast kernel's segmentation mode per step.
"""

from __future__ import annotations

import argparse
import logging
import time
from typing import Tuple

import torch
import torch.nn.functional as F

from ..sensors.raycast_sensor import render_camera
from ..sim import dynamics
from ..sim.convert import save_model_pickle
from ..sim.sim_builder import SimBuilder
from ..sim.structs import SimParams, SimState
from ..utils.collision_image_generator import render_inflated_depth
from .vae import Autoencoder, DepthVAE, seeded, vae_loss
from .vit import DepthViT

logger = logging.getLogger("train_vae")


def sample_batch(params_sim: SimParams, state: SimState, hw: Tuple[int, int],
                 collision_targets: bool = False):
    """Teleport every robot to a random pose and render fresh depth images
    -> (state, inputs, targets), images (B, H, W, 1) in [0, 1]. Targets are
    the inputs, or with ``collision_targets`` the depth of the scene
    inflated by the robot's collision radius over the camera's range (the
    latent then learns where the robot fits). All randomness (poses,
    obstacles, sensor noise) comes from the state's generator."""
    n = state.num_envs
    state = dynamics.reset_envs(params_sim, state, torch.ones((n,), device=state.device))
    pixels, _ = render_camera(params_sim, state, gen=state.rng, want_seg=False)

    def to_img(px):
        images = px[:, None]
        if tuple(images.shape[-2:]) != tuple(hw):
            images = F.interpolate(images, size=tuple(hw), mode="nearest-exact")
        return torch.clamp(images, 0.0, 1.0).permute(0, 2, 3, 1)

    inputs = to_img(pixels)
    if not collision_targets:
        return state, inputs, inputs
    infl, _ = render_inflated_depth(params_sim, state)
    return state, inputs, to_img(torch.clamp(infl / params_sim.camera.max_range, 0.0, 1.0))


def train_step(model: Autoencoder, optimizer: torch.optim.Optimizer, params_sim: SimParams,
               state: SimState, generator: torch.Generator, kld_beta: float = 3.0,
               collision_targets: bool = False):
    """One update on a fresh batch -> (state, loss, bce, kld), the three
    losses 0-d tensors on the device (nothing is read back). ``generator``
    draws the latent noise."""
    with torch.no_grad():
        state, batch, targets = sample_batch(params_sim, state, model.out_hw, collision_targets)
    optimizer.zero_grad(set_to_none=True)
    loss, (bce, kld) = vae_loss(model, batch, generator=generator, kld_beta=kld_beta,
                                targets=targets)
    loss.backward()
    optimizer.step()
    return state, loss.detach(), bce, kld


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--latent_dim", type=int, default=64)
    p.add_argument("--image_h", type=int, default=135,
                   help="training resolution (the navigation task resizes its camera to it)")
    p.add_argument("--image_w", type=int, default=240)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--kld_beta", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--collision_targets", action="store_true",
                   help="reconstruct the depth of the scene inflated by the robot's collision "
                        "radius instead of the input")
    p.add_argument("--out", default="depth_vae_params.pkl")
    p.add_argument("--arch", choices=["conv", "vit"], default="conv",
                   help="the conv VAE or the ViT encoder with the conv decoder")
    p.add_argument("--vit_dim", type=int, default=128)
    p.add_argument("--vit_depth", type=int, default=4)
    p.add_argument("--vit_heads", type=int, default=4)
    p.add_argument("--vit_attn", choices=["xla", "fused", "flash"], default="xla",
                   help="'fused' runs the hand-written attention kernels (forward and "
                        "backward), 'flash' the same kernels in f32 whatever the input "
                        "type, 'xla' the plain version through autograd")
    p.add_argument("--vit_remat", action="store_true",
                   help="recompute each transformer block in the backward instead of "
                        "keeping its activations")
    p.add_argument("--device", default=None,
                   help="torch device; the default is CUDA, pass cpu to run without a GPU")
    p.add_argument("--log_every", type=int, default=100)
    return p


def build_model(args) -> Autoencoder:
    hw = (args.image_h, args.image_w)
    if args.arch == "vit":
        build = lambda: DepthViT(latent_dim=args.latent_dim, out_hw=hw, dim=args.vit_dim,
                                 depth=args.vit_depth, num_heads=args.vit_heads,
                                 attn_impl=args.vit_attn, remat=args.vit_remat)
    else:
        build = lambda: DepthVAE(latent_dim=args.latent_dim, out_hw=hw)
    return seeded(args.seed, build)


def train(args):
    """Run ``args.steps`` updates -> (model, history); history holds one
    dict (it, loss, bce, kld, wall_s) per logged step, read back from the
    device at the log points only."""
    env = SimBuilder().build_env("base_sim", "env_with_obstacles",
                                 "base_quadrotor_with_camera", "lee_velocity_control",
                                 device=args.device, num_envs=args.batch, seed=args.seed)
    model = build_model(args).to(env.device)
    optimizer = torch.optim.Adam(model.parameters(), lr=args.lr, eps=1e-8)
    generator = torch.Generator(device=env.device)
    generator.manual_seed(args.seed)
    state, history = env.state, []
    t0 = time.perf_counter()
    for it in range(args.steps):
        state, loss, bce, kld = train_step(model, optimizer, env.params, state, generator,
                                           args.kld_beta, args.collision_targets)
        if it % args.log_every == 0 or it == args.steps - 1:
            loss, bce, kld = torch.stack([loss, bce, kld]).tolist()
            history.append({"it": it, "loss": loss, "bce": bce, "kld": kld,
                            "wall_s": time.perf_counter() - t0})
            logger.info("it %5d loss %.5f bce %.5f kld %.4f wall %.1fs", it, loss, bce, kld,
                        history[-1]["wall_s"])
    return model, history


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="[%(name)s] %(message)s")
    model, _ = train(args)
    save_model_pickle(model, args.out)
    logger.info("saved %s autoencoder parameters to %s", args.arch, args.out)
    return args.out


if __name__ == "__main__":
    main()
