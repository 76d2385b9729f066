"""Port parity for perception training: the conv decoder layer by layer, the
whole autoencoders (DepthVAE, DepthViT), vae_loss with the gradient of every
parameter, one Adam step, the checkpoint round trip and train_vae itself,
against the JAX package with the parameters carried across
(sim/convert.py) and the same numpy-seeded images and latent noise.

Tolerances (f32 throughout):
  * one transposed convolution, the resize, the decoder, a whole forward:
    atol 2e-4 (the same sums in another order; observed 1e-6 and below);
  * vae_loss: value 1e-5; gradients atol 5e-3 as
    tests/test_attention_pallas.py::test_vit_fused_gradients_finite_and_close
    holds the JAX package's own two attention paths, tightened to 2e-4 +
    rtol 1e-3, which holds here;
  * two Adam steps from the same gradients: 5e-7 on every parameter (a few
    f32 ulps of weights of magnitude 1; one update moves a weight by 1e-4);
  * parameter trees there and back: exact.
On the CPU the port's "fused" attention runs its plain forward and backward;
the JAX side runs its Pallas kernels in interpret mode.
"""

import functools
import pickle

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from aerial_gym_simulator_tpu.models.vae import Decoder as JDecoder
from aerial_gym_simulator_tpu.models.vae import DepthVAE as JDepthVAE
from aerial_gym_simulator_tpu.models.vae import VAEImageEncoder as JVAEImageEncoder
from aerial_gym_simulator_tpu.models.vae import vae_loss as j_vae_loss
from aerial_gym_simulator_tpu.models.vit import DepthViT as JDepthViT
from aerial_gym_simulator_tpu.models.vit import ViTImageEncoder as JViTImageEncoder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.models import train_vae
from aerial_gym_simulator_tpu_torch.models.vae import (
    Decoder, SameConvTranspose2d, VAEImageEncoder, resize_bilinear, vae_loss)
from aerial_gym_simulator_tpu_torch.models.vit import DepthViT, ViTImageEncoder
from aerial_gym_simulator_tpu_torch.sim import convert as cv
from aerial_gym_simulator_tpu_torch.sim.structs import replace

HW = (27, 48)
VIT_KW = dict(latent_dim=8, out_hw=(36, 48), patch=(9, 16), dim=32, depth=2, num_heads=2)
VIT_GRAD_KW = dict(VIT_KW, depth=1)            # one block: the JAX side compiles faster
# one head at the shipped width (head_dim 256, the one-pass wide kernels on the
# card) and at the large ViT's (head_dim 512, the cluster kernels)
VIT_WIDE_KW = dict(VIT_KW, dim=256, depth=1, num_heads=1)


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run thousands of tiny eager ops; torch's intra-op threads
    buy them nothing and, when several test workers share the cores, their
    spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def images(shape, seed=0):
    """Depth-like images in [0, 1]: coarse random blocks, upsampled."""
    rs = np.random.RandomState(seed)
    b, h, w = shape
    coarse = rs.uniform(0.05, 1.0, (b, -(-h // 9), -(-w // 16))).astype(np.float32)
    return np.repeat(np.repeat(coarse, 9, axis=1), 16, axis=2)[:, :h, :w, None]


def perturbed(params, seed):
    """flax initialises biases to zero; make every leaf matter."""
    rs = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a) + 0.05 * rs.standard_normal(np.shape(a)).astype(np.float32),
        to_numpy_tree(params))


@functools.lru_cache(maxsize=None)
def vit_params(depth: int):
    """Perturbed DepthViT parameters, initialised once per depth (the tree
    does not depend on attn_impl or remat)."""
    x = jnp.zeros((1, 36, 48, 1))
    key = jax.random.PRNGKey(depth)
    model = JDepthViT(attn_impl="xla", **dict(VIT_KW, depth=depth))
    return perturbed(model.init(key, x, key), seed=depth)


def vit_wide_params(kw):
    """Perturbed DepthViT parameters at ``kw``, from the port's seeded
    initialisation carried across (flax's eager init at this width costs
    more than the whole comparison)."""
    torch.manual_seed(7)
    model = DepthViT(**kw)
    return perturbed(cv.depth_vit_to_flax(model), seed=7)


@functools.lru_cache(maxsize=None)
def vae_params():
    key = jax.random.PRNGKey(0)
    return perturbed(JDepthVAE(latent_dim=8, out_hw=HW).init(key, jnp.zeros((1,) + HW + (1,)),
                                                            key), seed=0)


def assert_trees_close(got, want, atol, rtol=0.0):
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [p for p, _ in flat_g] == [p for p, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=atol, rtol=rtol,
                                   err_msg=jax.tree_util.keystr(path))


# ---------------------------------------------------------------------------
# the decoder, piece by piece
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cin,cout,k,s", [(8, 8, 3, 1), (8, 4, 5, 2), (4, 4, 6, 4), (4, 2, 6, 2),
                                          (2, 1, 4, 2)], ids=lambda v: str(v))
def test_transposed_convolution_matches_flax_same_padding(cin, cout, k, s):
    """The decoder's five (kernel, stride) pairs, each alone: output = input
    x stride, the kernel not flipped."""
    rs = np.random.RandomState(k * 10 + s)
    x = rs.standard_normal((2, 5, 7, cin)).astype(np.float32)
    layer = nn.ConvTranspose(cout, (k, k), strides=(s, s), padding="SAME")
    params = perturbed(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)), seed=k)
    want = np.asarray(layer.apply(params, jnp.asarray(x)))
    deconv = SameConvTranspose2d(cin, cout, k, s)
    cv._set_deconv(deconv, params["params"])
    with torch.no_grad():
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert got.shape == (2, 5 * s, 7 * s, cout)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
    back = cv._deconv_to_flax(deconv)
    assert np.array_equal(back["kernel"], params["params"]["kernel"])


@pytest.mark.parametrize("hw", [(27, 48), (36, 48), (135, 240), (270, 480)],
                         ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_resize_matches_jax_antialiased_bilinear(hw):
    x = np.random.RandomState(1).standard_normal((1, 288, 480, 1)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1,) + hw + (1,), "bilinear"))
    got = resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), hw).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [HW, (36, 48)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_decoder_matches_jax(hw):
    z = np.random.RandomState(2).standard_normal((2, 16)).astype(np.float32)
    model = JDecoder(16, hw)
    params = perturbed(model.init(jax.random.PRNGKey(1), jnp.asarray(z)), seed=2)
    want = np.asarray(model.apply(params, jnp.asarray(z)))
    dec = cv.vae_decoder_from_flax(params, hw)
    with torch.no_grad():
        got = dec(torch.from_numpy(z))
    assert tuple(got.shape) == (2,) + hw + (1,)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# whole models, loss, gradients
# ---------------------------------------------------------------------------


def _jax_noise(key, shape):
    """The latent noise the JAX model draws from ``key``, as a tensor."""
    return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))


def test_depth_vae_forward_matches_jax():
    x = images((2,) + HW, seed=3)
    model = JDepthVAE(latent_dim=8, out_hw=HW)
    key = jax.random.PRNGKey(3)
    params = vae_params()
    recon_j, mean_j, logvar_j = model.apply(params, jnp.asarray(x), key)
    t = cv.depth_vae_from_flax(params, HW)
    with torch.no_grad():
        recon, mean, logvar = t(torch.from_numpy(x), noise=_jax_noise(key, (2, 8)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(t.decode(mean).detach().numpy(),
                               np.asarray(model.apply(params, mean_j, method=JDepthVAE.decode)),
                               atol=2e-4, rtol=0)


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_depth_vit_forward_matches_jax(attn_impl):
    x = images((2, 36, 48), seed=4)
    model = JDepthViT(attn_impl=attn_impl, **VIT_KW)
    key = jax.random.PRNGKey(4)
    params = vit_params(2)
    recon_j, mean_j, logvar_j = model.apply(params, jnp.asarray(x), key)
    t = cv.depth_vit_from_flax(params, (36, 48), attn_impl=attn_impl)
    with torch.no_grad():
        recon, mean, logvar = t(torch.from_numpy(x), noise=_jax_noise(key, (2, 8)))
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(logvar.numpy(), np.asarray(logvar_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(recon.numpy(), np.asarray(recon_j), atol=2e-4, rtol=0)


def _grads_as_flax(model, to_flax):
    """The gradients of every parameter, in the flax tree's layout."""
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(p.grad)
    return to_flax(model)


def _loss_and_grads_match(j_model, params, t_model, to_flax, x, key, jit=False):
    grad_fn = jax.value_and_grad(lambda p: j_vae_loss(j_model, p, jnp.asarray(x), key, 3.0),
                                 has_aux=True)
    (loss_j, (bce_j, kld_j)), grads_j = (jax.jit(grad_fn) if jit else grad_fn)(params)
    noise = _jax_noise(key, (x.shape[0], j_model.latent_dim))
    loss, (bce, kld) = vae_loss(t_model, torch.from_numpy(x), noise=noise, kld_beta=3.0)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(bce), float(bce_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(kld), float(kld_j), atol=1e-5, rtol=1e-5)
    assert all(p.grad is not None and torch.isfinite(p.grad).all()
               for p in t_model.parameters())
    assert_trees_close(_grads_as_flax(t_model, to_flax), to_numpy_tree(grads_j),
                       atol=2e-4, rtol=1e-3)


@pytest.mark.parametrize("remat", [False, True], ids=["keep", "remat"])
@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
def test_vit_vae_loss_and_every_gradient_match_jax(attn_impl, remat):
    x = images((2, 36, 48), seed=5)
    j_model = JDepthViT(attn_impl=attn_impl, remat=remat, **VIT_GRAD_KW)
    key = jax.random.PRNGKey(5)
    params = vit_params(1)
    t_model = cv.depth_vit_from_flax(params, (36, 48), attn_impl=attn_impl, remat=remat)
    assert t_model.encoder.remat == remat
    _loss_and_grads_match(j_model, params, t_model, cv.depth_vit_to_flax, x, key)


@pytest.mark.parametrize("dim", [256, 512], ids=["dim256", "dim512"])
def test_vit_one_wide_head_forward_and_every_gradient_match_jax(dim):
    """dim 256 or 512 at one head (head_dim 256: the one-pass wide kernels
    on the card; 512: the cluster kernels) through "fused" attention, depth
    1: the forward, vae_loss and the gradient of every parameter against the
    JAX package (its Pallas kernel interpreted, the JAX side jitted to keep
    the test short) at the bars above."""
    kw = dict(VIT_WIDE_KW, dim=dim)
    x = images((2, 36, 48), seed=8)
    j_model = JDepthViT(attn_impl="fused", **kw)
    key = jax.random.PRNGKey(8)
    params = vit_wide_params(kw)
    recon_j, mean_j, logvar_j = jax.jit(j_model.apply)(params, jnp.asarray(x), key)
    t_model = cv.depth_vit_from_flax(params, (36, 48), attn_impl="fused")
    assert t_model.encoder.blocks[0].attn.num_heads == 1
    with torch.no_grad():
        recon, mean, logvar = t_model(torch.from_numpy(x), noise=_jax_noise(key, (2, 8)))
    for got, want in ((mean, mean_j), (logvar, logvar_j), (recon, recon_j)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=0)
    _loss_and_grads_match(j_model, params, t_model, cv.depth_vit_to_flax, x, key, jit=True)


def test_conv_vae_loss_and_every_gradient_match_jax():
    x = images((2,) + HW, seed=6)
    j_model = JDepthVAE(latent_dim=8, out_hw=HW)
    key = jax.random.PRNGKey(6)
    params = vae_params()
    _loss_and_grads_match(j_model, params, cv.depth_vae_from_flax(params, HW),
                          cv.depth_vae_to_flax, x, key)


def test_vae_loss_takes_targets_and_divides_kld_by_pixels():
    x = images((2,) + HW, seed=7)
    tgt = np.clip(x * 0.5, 0.0, 1.0)
    j_model = JDepthVAE(latent_dim=8, out_hw=HW)
    key = jax.random.PRNGKey(7)
    params = vae_params()
    loss_j, (bce_j, kld_j) = j_vae_loss(j_model, params, jnp.asarray(x), key, 5.0,
                                        targets=jnp.asarray(tgt))
    t_model = cv.depth_vae_from_flax(params, HW)
    with torch.no_grad():
        loss, (bce, kld) = vae_loss(t_model, torch.from_numpy(x),
                                    noise=_jax_noise(key, (2, 8)),
                                    kld_beta=5.0, targets=torch.from_numpy(tgt))
    np.testing.assert_allclose(float(loss), float(loss_j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(loss), float(bce) + 5.0 * float(kld) / (HW[0] * HW[1]),
                               atol=1e-6, rtol=0)


def test_one_adam_step_from_the_same_gradients_matches_optax():
    """optax.adam(lr) and torch.optim.Adam(lr, eps=1e-8) put epsilon in the
    same place; gradients of mixed magnitudes, made with numpy."""
    params = vit_params(1)
    rs = np.random.RandomState(8)
    grads = jax.tree_util.tree_map(
        lambda a: (rs.standard_normal(a.shape) * 10.0 ** rs.uniform(-9, 0, a.shape))
        .astype(np.float32), params)
    tx = optax.adam(1e-4)
    state = tx.init(params)
    want = params
    for _ in range(2):
        updates, state = tx.update(grads, state)
        want = optax.apply_updates(want, updates)

    t_model = cv.depth_vit_from_flax(params, (36, 48), attn_impl="xla")
    g_model = cv.depth_vit_from_flax(grads, (36, 48), attn_impl="xla")
    opt = torch.optim.Adam(t_model.parameters(), lr=1e-4, eps=1e-8)
    for _ in range(2):
        for p, g in zip(t_model.parameters(), g_model.parameters()):
            p.grad = g.detach().clone()
        opt.step()
    assert_trees_close(cv.depth_vit_to_flax(t_model), to_numpy_tree(want), atol=5e-7)


# ---------------------------------------------------------------------------
# checkpoints there and back
# ---------------------------------------------------------------------------


def test_depth_vit_parameters_round_trip_leaf_for_leaf():
    params = vit_params(2)
    back = cv.depth_vit_to_flax(cv.depth_vit_from_flax(params, (36, 48)))
    assert_trees_close(back, params, atol=0.0)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    assert all(np.asarray(a).dtype == np.float32 for a in jax.tree_util.tree_leaves(back))


def test_depth_vae_parameters_round_trip_leaf_for_leaf():
    params = vae_params()
    back = cv.depth_vae_to_flax(cv.depth_vae_from_flax(params, HW))
    assert_trees_close(back, params, atol=0.0)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)


SMALL = ["--steps", "3", "--batch", "2", "--image_h", "36", "--image_w", "48",
         "--latent_dim", "8", "--device", "cpu", "--log_every", "1"]


def test_train_vae_vit_pickle_is_read_by_both_packages(tmp_path):
    out = str(tmp_path / "vit.pkl")
    assert train_vae.main(SMALL + ["--arch", "vit", "--vit_attn", "fused", "--vit_dim", "32",
                                   "--vit_depth", "2", "--vit_heads", "2", "--out", out]) == out
    with open(out, "rb") as f:
        blob = pickle.load(f)
    assert {k: blob[k] for k in ("arch", "patch", "dim", "depth", "num_heads", "attn_impl")} == {
        "arch": "vit", "patch": (9, 16), "dim": 32, "depth": 2, "num_heads": 2,
        "attn_impl": "fused"}
    arch, model = cv.load_model_pickle(out, (36, 48))
    assert arch == "vit" and cv.load_encoder_pickle(out)[0] == "vit"
    x = images((2, 36, 48), seed=11)
    with torch.no_grad():
        mean_t, _ = model.encode(torch.from_numpy(x))
    kw = {k: blob[k] for k in ("patch", "dim", "depth", "num_heads", "attn_impl")}
    j = JViTImageEncoder(latent_dim=8, image_res=(36, 48), params=blob["params"],
                         compute_dtype=jnp.float32, **kw)
    np.testing.assert_allclose(np.asarray(j.encode(jnp.asarray(x[..., 0]))), mean_t.numpy(),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(j.decode(jnp.asarray(mean_t.numpy()))),
                               model.decode(mean_t).detach().numpy(), atol=2e-4, rtol=0)
    # the port's own frozen wrapper serves the same encoder and decoder
    t = ViTImageEncoder(latent_dim=8, image_res=(36, 48), encoder=model.encoder,
                        decoder=model.decoder, compute_dtype=torch.float32, patch=(9, 16),
                        device="cpu")
    torch.testing.assert_close(t.encode(torch.from_numpy(x[..., 0])), mean_t)
    torch.testing.assert_close(t.decode(mean_t), model.decode(mean_t).detach())


def test_train_vae_conv_pickle_is_read_by_both_packages(tmp_path):
    out = str(tmp_path / "vae.pkl")
    train_vae.main(SMALL + ["--arch", "conv", "--out", out])
    with open(out, "rb") as f:
        params = pickle.load(f)
    assert set(params) == {"params"} and set(params["params"]) == {"encoder", "decoder"}
    arch, model = cv.load_model_pickle(out, (36, 48))
    assert arch == "conv"
    x = images((2, 36, 48), seed=12)
    j = JVAEImageEncoder(latent_dim=8, image_res=(36, 48), params=params,
                         compute_dtype=jnp.float32)
    t = VAEImageEncoder(latent_dim=8, image_res=(36, 48), encoder=model.encoder,
                        decoder=model.decoder, compute_dtype=torch.float32, device="cpu")
    mean_t = t.encode(torch.from_numpy(x[..., 0]))
    np.testing.assert_allclose(np.asarray(j.encode(jnp.asarray(x[..., 0]))), mean_t.numpy(),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(np.asarray(j.decode(jnp.asarray(mean_t.numpy()))),
                               t.decode(mean_t).numpy(), atol=2e-4, rtol=0)


# ---------------------------------------------------------------------------
# the training loop's pieces
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def small_env():
    return port.SimBuilder().build_env("base_sim", "env_with_obstacles",
                                       "base_quadrotor_with_camera", "lee_velocity_control",
                                       device="cpu", num_envs=2, seed=0)


def test_sample_batch_renders_fresh_images(small_env):
    state, inputs, targets = train_vae.sample_batch(small_env.params, small_env.state, (36, 48))
    assert tuple(inputs.shape) == (2, 36, 48, 1) and targets is inputs
    assert float(inputs.min()) >= 0.0 and float(inputs.max()) <= 1.0
    assert not torch.equal(state.pos, small_env.state.pos)          # teleported
    _, again, _ = train_vae.sample_batch(small_env.params, state, (36, 48))
    assert not torch.equal(again, inputs)
    # collision targets: the inflated scene's depth, not the inputs, in [0, 1]
    # (from a generator of its own: the module's env keeps its stream)
    own = replace(state, rng=torch.Generator().manual_seed(3))
    _, inputs, targets = train_vae.sample_batch(small_env.params, own, (36, 48),
                                                collision_targets=True)
    assert tuple(targets.shape) == tuple(inputs.shape) and not torch.equal(targets, inputs)
    assert float(targets.min()) >= 0.0 and float(targets.max()) <= 1.0


def test_train_step_lowers_the_loss_on_cpu(small_env):
    """Twenty updates on fresh batches lower the loss on a batch held back
    (fixed noise); every logged loss is a finite 0-d tensor."""
    args = train_vae.build_parser().parse_args(SMALL + ["--arch", "vit", "--vit_dim", "32",
                                                        "--vit_depth", "1", "--vit_heads", "2",
                                                        "--vit_attn", "fused", "--vit_remat"])
    model = train_vae.build_model(args)
    before = [p.detach().clone() for p in model.parameters()]
    opt = torch.optim.Adam(model.parameters(), lr=3e-3, eps=1e-8)
    gen = torch.Generator().manual_seed(0)
    state, held, _ = train_vae.sample_batch(small_env.params, small_env.state, (36, 48))
    held_loss = lambda: float(vae_loss(model, held, noise=torch.zeros(2, 8))[0].detach())
    first = held_loss()
    for _ in range(20):
        state, loss, bce, kld = train_vae.train_step(model, opt, small_env.params, state, gen)
        assert loss.dim() == 0 and torch.isfinite(torch.stack([loss, bce, kld])).all()
    assert held_loss() < first
    assert all(not torch.equal(a, b) for a, b in zip(before, model.parameters()))


def test_train_vae_refuses_what_is_not_ported():
    # the JAX script's choices are xla, fused and flash
    assert train_vae.build_parser().parse_args(["--vit_attn", "flash"]).vit_attn == "flash"
    with pytest.raises(SystemExit):
        train_vae.build_parser().parse_args(["--vit_attn", "reference"])
    with pytest.raises(ValueError, match="without a decoder"):
        enc = cv.load_encoder_pickle(
            "examples/dce_rl_navigation/selected_network/depth_vae.pkl")[1]
        VAEImageEncoder(encoder=enc, image_res=(135, 240), device="cpu").decode(
            torch.zeros(1, 64))


def test_random_image_encoders_decode_like_the_jax_wrappers():
    t = VAEImageEncoder(latent_dim=8, image_res=HW, device="cpu")
    assert isinstance(t.decoder, Decoder)
    assert tuple(t.decode(torch.zeros(3, 8)).shape) == (3,) + HW + (1,)
    v = ViTImageEncoder(latent_dim=8, image_res=(30, 50), dim=32, depth=1, num_heads=2,
                        device="cpu")
    assert v.input_hw == (27, 48) and tuple(v.decode(torch.zeros(1, 8)).shape) == (1, 30, 50, 1)
