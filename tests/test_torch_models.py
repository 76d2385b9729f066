"""Port parity for the perception encoders and the policy network: the
JAX package's DepthViT / DepthVAE encoders and NumpyPolicy against the
port's modules, with the weights carried across by sim/convert.py and the
same numpy-seeded images through both.

Tolerances:
  * small random-weight models in f32: atol 2e-4 (same algorithm, other
    summation order in the convolutions and products);
  * the shipped encoders at full width in f32: atol 1e-3 on the mean
    latent (four blocks of dim 256 accumulate more rounding);
  * the shipped ViT in bf16: atol 0.05 plus rtol 0.05, the pair the
    attention kernel is held to in bf16. The two frameworks round to bf16
    at different places (flax's GELU and attention softmax round every
    step to bf16, torch computes them in f32 and rounds once): over three
    image seeds the two bf16 results differ by up to 0.057 at latents of
    magnitude ~0.7, while each differs from the f32 result by 0.06-0.10;
  * the policy MLP: atol 1e-5.
On the CPU the port's "fused" attention runs its plain version; the JAX
side runs its Pallas kernel in interpret mode.
"""

import copy
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aerial_gym_simulator_tpu.models.vae import DepthVAE
from aerial_gym_simulator_tpu.models.vae import VAEImageEncoder as JVAEImageEncoder
from aerial_gym_simulator_tpu.models.vit import DepthViT
from aerial_gym_simulator_tpu.models.vit import ViTImageEncoder as JViTImageEncoder
from aerial_gym_simulator_tpu.sim2real.numpy_policy import NumpyPolicy

from aerial_gym_simulator_tpu_torch.models.vae import SameConv2d, VAEImageEncoder
from aerial_gym_simulator_tpu_torch.models.vit import ViTImageEncoder
from aerial_gym_simulator_tpu_torch.sim.convert import (
    load_encoder_pickle, vae_encoder_from_flax, vit_encoder_from_flax)
from aerial_gym_simulator_tpu_torch.sim2real.policy import MLPPolicy, load_policy_npz


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run many eager ops on small tensors; torch's intra-op
    threads buy them little and, when several test workers share the cores,
    their spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


NET = os.path.join(os.path.dirname(__file__), "..", "examples", "dce_rl_navigation",
                   "selected_network")
VIT_ENC = os.path.join(NET, "vit_depth_encoder.pkl")
VAE_ENC = os.path.join(NET, "depth_vae.pkl")
VIT_NPZ = os.path.join(NET, "vit_navigation_policy.npz")
RADAR_NPZ = os.path.join(NET, "radar_navigation_policy.npz")


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, jax.device_get(tree))


def images(shape, seed=0):
    """Depth-like images in [0, 1]: coarse random blocks, upsampled."""
    rs = np.random.RandomState(seed)
    b, h, w = shape
    coarse = rs.uniform(0.05, 1.0, (b, -(-h // 9), -(-w // 16))).astype(np.float32)
    return np.repeat(np.repeat(coarse, 9, axis=1), 16, axis=2)[:, :h, :w]


@pytest.mark.parametrize("attn_impl", ["xla", "fused"])
@pytest.mark.parametrize("hw", [(135, 240), (27, 48)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_small_vit_encoder_matches_jax(hw, attn_impl):
    model = DepthViT(latent_dim=16, out_hw=(27, 48), dim=32, depth=2, num_heads=4,
                     attn_impl=attn_impl)
    x = images((2,) + hw)[..., None]
    key = jax.random.PRNGKey(0)
    params = model.init(key, jnp.asarray(x), key)
    mean_j, logvar_j = model.apply(params, jnp.asarray(x), method=DepthViT.encode)
    enc = vit_encoder_from_flax(to_numpy_tree(params), attn_impl=attn_impl)
    assert enc.blocks[0].attn.impl == attn_impl and len(enc.blocks) == 2
    with torch.no_grad():
        mean_t, logvar_t = enc(torch.from_numpy(x))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), atol=2e-4, rtol=0)


@pytest.mark.parametrize("hw", [(135, 240), (27, 48)], ids=lambda hw: f"{hw[0]}x{hw[1]}")
def test_vae_encoder_matches_jax(hw):
    model = DepthVAE(latent_dim=16, out_hw=hw)
    x = images((2,) + hw, seed=1)[..., None]
    key = jax.random.PRNGKey(1)
    params = model.init(key, jnp.asarray(x), key)
    mean_j, logvar_j = model.apply(params, jnp.asarray(x), method=DepthVAE.encode)
    enc = vae_encoder_from_flax(to_numpy_tree(params), input_hw=hw)
    with torch.no_grad():
        mean_t, logvar_t = enc(torch.from_numpy(x))
    np.testing.assert_allclose(mean_t.numpy(), np.asarray(mean_j), atol=2e-4, rtol=0)
    np.testing.assert_allclose(logvar_t.numpy(), np.asarray(logvar_j), atol=2e-4, rtol=0)


@pytest.mark.parametrize("n,k,s", [(135, 5, 2), (240, 5, 2), (17, 4, 2), (17, 5, 4), (9, 3, 1)])
def test_same_padding_gives_flax_output_size(n, k, s):
    conv = SameConv2d(1, 1, k, stride=s)
    assert conv(torch.zeros(1, 1, n, n)).shape[-1] == -(-n // s)


@pytest.fixture(scope="module")
def shipped_vit():
    with open(VIT_ENC, "rb") as f:
        tagged = pickle.load(f)
    arch, enc = load_encoder_pickle(VIT_ENC)
    assert arch == "vit" and enc.blocks[0].attn.impl == "fused"      # the shipped tag
    return tagged, enc


@pytest.mark.parametrize("dtype,atol,rtol", [("float32", 1e-3, 0.0), ("bfloat16", 0.05, 0.05)])
def test_shipped_vit_encoder_matches_jax(shipped_vit, dtype, atol, rtol):
    tagged, enc = shipped_vit
    kw = {k: tagged[k] for k in ("patch", "dim", "depth", "num_heads", "attn_impl")}
    x = images((2, 135, 240), seed=2)
    j = JViTImageEncoder(latent_dim=64, image_res=(135, 240), params=tagged["params"],
                         compute_dtype=getattr(jnp, dtype), **kw)
    mean_j = np.asarray(j.encode(jnp.asarray(x)))
    t = ViTImageEncoder(latent_dim=64, image_res=(135, 240), encoder=copy.deepcopy(enc),
                        compute_dtype=getattr(torch, dtype), patch=enc.patch, device="cpu")
    mean_t = t.encode(torch.from_numpy(x))
    assert mean_t.dtype == torch.float32 and mean_t.shape == (2, 64)
    np.testing.assert_allclose(mean_t.numpy(), mean_j, atol=atol, rtol=rtol)
    # a sample needs a generator (or the noise itself); without, the mean
    z = t.encode(torch.from_numpy(x), generator=torch.Generator().manual_seed(0))
    assert not torch.equal(z, mean_t) and torch.isfinite(z).all()
    noise = torch.ones(2, 64)
    mean, logvar = t.encode_moments(torch.from_numpy(x))
    torch.testing.assert_close(t.encode(torch.from_numpy(x), noise=noise),
                               mean + torch.exp(0.5 * logvar))


def test_shipped_vae_encoder_matches_jax():
    with open(VAE_ENC, "rb") as f:
        params = pickle.load(f)
    x = images((2, 135, 240), seed=3)
    j = JVAEImageEncoder(latent_dim=64, image_res=(135, 240), params=params,
                         compute_dtype=jnp.float32)
    arch, enc = load_encoder_pickle(VAE_ENC, (135, 240))
    assert arch == "conv"
    t = VAEImageEncoder(latent_dim=64, image_res=(135, 240), encoder=enc,
                        compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(t.encode(torch.from_numpy(x)).numpy(),
                               np.asarray(j.encode(jnp.asarray(x))), atol=1e-3, rtol=0)


def test_image_encoder_resizes_like_jax():
    """A 27x48 camera feeds the 135x240 encoder through a nearest resize."""
    x = images((2, 27, 48), seed=4)
    j = JVAEImageEncoder(latent_dim=8, image_res=(135, 240), compute_dtype=jnp.float32)
    enc = vae_encoder_from_flax(to_numpy_tree(j.params), input_hw=(135, 240))
    t = VAEImageEncoder(latent_dim=8, image_res=(135, 240), encoder=enc,
                        compute_dtype=torch.float32, device="cpu")
    np.testing.assert_allclose(t.encode(torch.from_numpy(x)).numpy(),
                               np.asarray(j.encode(jnp.asarray(x))), atol=2e-4, rtol=0)


def test_mlp_policy_matches_numpy_policy():
    obs = np.random.RandomState(5).normal(scale=3.0, size=(16, 81)).astype(np.float32)
    ref = NumpyPolicy(VIT_NPZ)(obs)
    policy = load_policy_npz(VIT_NPZ, device="cpu")
    assert isinstance(policy, MLPPolicy) and policy.action_dim == 4
    np.testing.assert_allclose(policy(torch.from_numpy(obs)).numpy(), ref, atol=1e-5, rtol=0)


def test_recurrent_archives_are_refused(tmp_path):
    """A recurrent archive loads (tests/test_torch_ppo_rnn.py holds it to the
    JAX package's loader); one whose core is not a GRU is refused."""
    from aerial_gym_simulator_tpu_torch.sim2real.policy import RecurrentPolicy
    assert isinstance(load_policy_npz(RADAR_NPZ, device="cpu"), RecurrentPolicy)
    with np.load(RADAR_NPZ) as z:
        archive = {k: z[k] for k in z.files}
    archive["gru_Wih"] = np.concatenate([archive["gru_Wih"], archive["gru_Wih"][:128]])
    path = str(tmp_path / "lstm_like.npz")                 # four gates: an LSTM's layout
    np.savez(path, **archive)
    with pytest.raises(ValueError, match="recurrent core"):
        load_policy_npz(path, device="cpu")


def test_unknown_attention_impl_is_refused():
    with pytest.raises(ValueError, match="unknown attention impl"):
        ViTImageEncoder(image_res=(27, 48), dim=32, depth=1, num_heads=4,
                        attn_impl="pallas", device="cpu")


def _retagged(tmp_path, tag):
    """The shipped ViT encoder's pickle with its attn_impl tag replaced."""
    with open(VIT_ENC, "rb") as f:
        blob = pickle.load(f)
    blob["attn_impl"] = tag
    path = str(tmp_path / f"vit_{tag}.pkl")
    with open(path, "wb") as f:
        pickle.dump(blob, f)
    return blob, path


@pytest.mark.parametrize("tag", ["flash", "reference"])
def test_retagged_vit_pickle_gives_the_fused_latents(shipped_vit, tmp_path, tag):
    """The JAX package writes "flash" (train_vae --vit_attn flash) and
    accepts "reference"; the checkpoints are interchangeable. Both tags
    load, keep their tag through load_model_pickle and save_model_pickle,
    and give the "fused" pickle's f32 latents within the shipped-encoder
    bar."""
    from aerial_gym_simulator_tpu_torch.sim.convert import load_model_pickle, save_model_pickle
    _, fused = shipped_vit
    _, path = _retagged(tmp_path, tag)
    arch, enc = load_encoder_pickle(path)
    assert arch == "vit" and all(b.attn.impl == tag for b in enc.blocks)
    x = torch.from_numpy(images((2, 135, 240), seed=6))
    encode = lambda e: ViTImageEncoder(latent_dim=64, image_res=(135, 240), encoder=e,
                                       compute_dtype=torch.float32, patch=e.patch,
                                       device="cpu").encode(x)
    np.testing.assert_allclose(encode(enc).numpy(), encode(copy.deepcopy(fused)).numpy(),
                               atol=1e-3, rtol=0)
    arch, model = load_model_pickle(path)
    assert arch == "vit" and model.encoder.blocks[0].attn.impl == tag
    again = str(tmp_path / "again.pkl")
    save_model_pickle(model, again)
    with open(again, "rb") as f:
        assert pickle.load(f)["attn_impl"] == tag


@pytest.mark.parametrize("tag", ["flash", "reference"])
def test_retagged_vit_encoder_matches_jax(tmp_path, tag):
    """A "flash"- or "reference"-tagged encoder through sim/convert.py
    against the JAX package's ViTImageEncoder built from the same pickle, f32
    at the shipped-encoder bar (the JAX side runs its XLA attention on the
    CPU for "flash", mha_reference for "reference")."""
    blob, path = _retagged(tmp_path, tag)
    kw = {k: blob[k] for k in ("patch", "dim", "depth", "num_heads", "attn_impl")}
    x = images((2, 135, 240), seed=7)
    j = JViTImageEncoder(latent_dim=64, image_res=(135, 240), params=blob["params"],
                         compute_dtype=jnp.float32, **kw)
    _, enc = load_encoder_pickle(path)
    t = ViTImageEncoder(latent_dim=64, image_res=(135, 240), encoder=enc,
                        compute_dtype=torch.float32, patch=enc.patch, device="cpu")
    np.testing.assert_allclose(t.encode(torch.from_numpy(x)).numpy(),
                               np.asarray(j.encode(jnp.asarray(x))), atol=1e-3, rtol=0)


def test_flash_attention_runs_in_f32_and_casts_back():
    """``"flash"`` casts q, k, v to f32 for the fused attention and its
    result back to the input type, as the JAX package's flash path does."""
    from aerial_gym_simulator_tpu_torch.models.vit import FusedAttention
    from aerial_gym_simulator_tpu_torch.ops.attention import attention_reference
    torch.manual_seed(0)
    layer = FusedAttention(32, 2, impl="flash").to(torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(8).standard_normal((2, 9, 32))
                         .astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        out = layer(x)
        q, k, v = layer.query(x), layer.key(x), layer.value(x)
        o = attention_reference(q.float(), k.float(), v.float(), 2, 0.25).to(torch.bfloat16)
        want = layer.out(o)
    assert out.dtype == torch.bfloat16 and torch.equal(out, want)
