"""Carry parameters, state and trained weights across from nested numpy
dicts.

The dicts are keyed by the record field names (the JAX package's
dataclass field names, which the port keeps), with numpy arrays or Python
scalars as leaves and nested dicts for nested records. This is how a state
reached by another implementation is continued here, and how the
perception checkpoints the JAX package trained (pickled flax parameter
trees, plain numpy inside) become the port's modules. The way back
(``depth_vit_to_flax``, ``depth_vae_to_flax``, ``save_model_pickle``) writes
the same trees, so a model trained here loads in either package.
"""

from __future__ import annotations

import dataclasses
import pickle

import numpy as np
import torch

from .structs import (
    ArtParams,
    ControllerParams,
    DofParams,
    EnvParams,
    ImuParams,
    MotorParams,
    RaySensorParams,
    RobotParams,
    SceneParams,
    SimParams,
    SimState,
)

_INT64_FIELDS = {"env_prim_slot"}   # used as gather indices


def record_to_numpy(obj):
    """A dataclass record (this package's or any framework's) -> nested
    dict with numpy leaves; None and Python scalars pass through."""
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if dataclasses.is_dataclass(obj):
        return {f.name: record_to_numpy(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if hasattr(obj, "_asdict"):                                         # a NamedTuple
        return {k: record_to_numpy(v) for k, v in obj._asdict().items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    if isinstance(obj, torch.Generator):
        return None
    return np.asarray(obj)


def _record(cls, d: dict, device):
    kw = {}
    for f in dataclasses.fields(cls):
        v = d[f.name]
        if f.type == "Tensor":
            arr = np.array(v)  # a writable copy
            if arr.dtype.kind in "iu":
                dtype = torch.int64 if f.name in _INT64_FIELDS else torch.int32
            elif arr.dtype.kind == "b":
                dtype = torch.bool
            else:
                dtype = torch.float32
            kw[f.name] = torch.as_tensor(arr, device=device).to(dtype).contiguous()
        elif f.type == "float":
            kw[f.name] = float(np.float32(v))
        elif f.type in ("int", "bool"):
            kw[f.name] = {"int": int, "bool": bool}[f.type](v)
        elif f.type.startswith("Tuple[int"):
            kw[f.name] = tuple(int(x) for x in np.asarray(v).reshape(-1))
        else:
            kw[f.name] = v
    return cls(**kw)


def params_from_numpy(d: dict, device) -> SimParams:
    """Nested dict of numpy leaves -> SimParams on ``device``: the robot,
    motors, controller and env, and where present the joints, the
    articulation (its tree structure as Python data), the obstacle scene,
    the camera, the lidar and the IMU."""
    opt = lambda cls, key: None if d.get(key) is None else _record(cls, d[key], device)
    return SimParams(
        dt=float(np.float32(d["dt"])),
        gravity=torch.as_tensor(np.array(d["gravity"], np.float32), device=device),
        robot=_record(RobotParams, d["robot"], device),
        motor=_record(MotorParams, d["motor"], device),
        controller=_record(ControllerParams, d["controller"], device),
        env=_record(EnvParams, d["env"], device),
        dof=opt(DofParams, "dof"),
        art=opt(ArtParams, "art"),
        scene=opt(SceneParams, "scene"),
        camera=opt(RaySensorParams, "camera"),
        lidar=opt(RaySensorParams, "lidar"),
        imu=opt(ImuParams, "imu"),
    )


def state_from_numpy(d: dict, device, seed: int = 0) -> SimState:
    """Nested dict of numpy leaves -> SimState on ``device``. A JAX ``rng``
    leaf (per-env keys) is dropped; the state gets a torch.Generator on
    ``device`` seeded with ``seed`` instead."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d = dict(d, rng=gen)
    kw = {}
    for f in dataclasses.fields(SimState):
        v = d[f.name]
        if f.name == "rng":
            kw[f.name] = v
            continue
        arr = np.array(v)  # a writable copy
        dtype = torch.int32 if arr.dtype.kind in "iu" else torch.float32
        kw[f.name] = torch.as_tensor(arr, device=device).to(dtype).contiguous()
    return SimState(**kw)


def nav_state_from_numpy(d: dict, device, seed: int = 0):
    """Nested dict of numpy leaves -> the navigation task's NavState on
    ``device``. The JAX ``key`` leaf is dropped: the task draws from the
    sim state's generator."""
    from ..tasks.navigation_task import NavState
    t = lambda name: torch.as_tensor(np.array(d[name], np.float32), device=device)
    return NavState(
        sim=state_from_numpy(d["sim"], device, seed=seed),
        target_position=t("target_position"), pos_error_prev=t("pos_error_prev"),
        prev_action=t("prev_action"), latents=t("latents"),
        curriculum_level=t("curriculum_level"), success_agg=t("success_agg"),
        crash_agg=t("crash_agg"), timeout_agg=t("timeout_agg"))


def lidar_nav_state_from_numpy(d: dict, device, seed: int = 0):
    """Nested dict of numpy leaves -> the LiDAR/radar navigation task's
    LidarNavState on ``device``. The JAX ``key`` leaf is dropped: the task
    draws from the sim state's generator."""
    from ..tasks.lidar_navigation_task import LidarNavState
    t = lambda name: torch.as_tensor(np.array(d[name], np.float32), device=device)
    fields = [f.name for f in dataclasses.fields(LidarNavState) if f.name != "sim"]
    return LidarNavState(sim=state_from_numpy(d["sim"], device, seed=seed),
                         **{name: t(name) for name in fields})


def variant_carry_from_numpy(d: dict, device, seed: int = 0):
    """Nested dict of numpy leaves -> the position-task variants'
    VariantCarry on ``device``. The JAX ``key`` leaf is dropped: the sim
    state gets a generator seeded with ``seed``, and the carry draws its
    observation noise from another, seeded with ``seed ^ 0x5EED`` as the
    task's reset seeds it."""
    from ..tasks.position_setpoint_variants import VariantCarry
    rng = torch.Generator(device=device)
    rng.manual_seed(seed ^ 0x5EED)
    return VariantCarry(
        sim=state_from_numpy(d["sim"], device, seed=seed),
        prev_action=torch.as_tensor(np.array(d["prev_action"], np.float32), device=device),
        rng=rng)


# ---------------------------------------------------------------------------
# encoder checkpoints (flax parameter trees)
# ---------------------------------------------------------------------------


def _encoder_subtree(params: dict) -> dict:
    """The encoder's parameters out of a flax variables dict
    ({"params": {"encoder": ..., "decoder": ...}}) or any subtree of it."""
    for key in ("params", "encoder"):
        if key in params:
            params = params[key]
    return params


def _set(param: torch.nn.Parameter, array):
    value = torch.as_tensor(np.array(array, np.float32))
    if value.shape != param.shape:
        raise ValueError(f"checkpoint leaf has shape {tuple(value.shape)}, "
                         f"the module expects {tuple(param.shape)}")
    with torch.no_grad():
        param.copy_(value)


def _set_dense(linear, leaf: dict):
    """flax Dense/DenseGeneral (kernel (in..., out...), bias (out...)) ->
    nn.Linear: flatten the in and out axes, transpose."""
    kernel, bias = np.asarray(leaf["kernel"]), np.asarray(leaf["bias"])
    _set(linear.weight, kernel.reshape(linear.in_features, linear.out_features).T)
    _set(linear.bias, bias.reshape(-1))


def _set_conv(conv, leaf: dict):
    """flax Conv kernel (kh, kw, in, out) -> nn.Conv2d weight (out, in, kh, kw)."""
    _set(conv.weight, np.transpose(np.asarray(leaf["kernel"]), (3, 2, 0, 1)))
    _set(conv.bias, leaf["bias"])


def _set_norm(norm, leaf: dict):
    _set(norm.weight, leaf["scale"])
    _set(norm.bias, leaf["bias"])


def vit_encoder_from_flax(params: dict, attn_impl: str = "fused"):
    """flax DepthViT / ViTEncoder parameters -> models.vit.ViTEncoder (f32,
    on the CPU). Sizes are read off the leaves' shapes."""
    from ..models.vit import ViTEncoder
    p = _encoder_subtree(params)
    ph, pw, _, dim = np.shape(p["patch_embed"]["kernel"])
    depth = sum(1 for k in p if k.startswith("block_"))
    num_heads = np.shape(p["block_0"]["attn"]["query"]["kernel"])[1]
    enc = ViTEncoder(latent_dim=np.shape(p["latent_head"]["bias"])[0] // 2, patch=(ph, pw),
                     dim=dim, depth=depth, num_heads=num_heads, attn_impl=attn_impl,
                     num_tokens=np.shape(p["pos_embed"])[1])
    _set_conv(enc.patch_embed, p["patch_embed"])
    _set(enc.pos_embed, p["pos_embed"])
    for i, block in enumerate(enc.blocks):
        b = p[f"block_{i}"]
        _set_norm(block.norm1, b["LayerNorm_0"])
        _set_norm(block.norm2, b["LayerNorm_1"])
        for name in ("query", "key", "value", "out"):
            _set_dense(getattr(block.attn, name), b["attn"][name])
        _set_dense(block.mlp_in, b["mlp_in"])
        _set_dense(block.mlp_out, b["mlp_out"])
    _set_norm(enc.norm, p["LayerNorm_0"])
    _set_dense(enc.latent_head, p["latent_head"])
    return enc


def tanh_policy_from_flax(params: dict, scale: float = 1.0):
    """flax rl.bptt.TanhPolicy parameters ({"params": {"Dense_0": ...}} or
    the inner dict) -> rl.bptt.TanhPolicy (f32, on the CPU). The widths are
    read off the kernels; the last Dense is the tanh head. ``scale`` is the
    module's action scale, which flax keeps outside the parameters."""
    from ..rl.bptt import TanhPolicy
    p = params.get("params", params)
    kernels = [np.shape(p[f"Dense_{i}"]["kernel"]) for i in range(len(p))]
    policy = TanhPolicy(kernels[0][0], kernels[-1][1], tuple(k[1] for k in kernels[:-1]), scale)
    for i, layer in enumerate(list(policy.hidden) + [policy.head]):
        _set_dense(layer, p[f"Dense_{i}"])
    return policy


def vae_encoder_from_flax(params: dict, input_hw=(135, 240)):
    """flax DepthVAE / Encoder parameters -> models.vae.Encoder (f32, on
    the CPU) for images of ``input_hw``."""
    from ..models.vae import Encoder
    p = _encoder_subtree(params)
    enc = Encoder(latent_dim=np.shape(p["Dense_1"]["bias"])[0] // 2, input_hw=input_hw)
    for i, conv in enumerate(enc.convs):
        _set_conv(conv, p[f"Conv_{i}"])
    _set_dense(enc.dense0, p["Dense_0"])
    _set_dense(enc.dense1, p["Dense_1"])
    return enc


def _set_deconv(deconv, leaf: dict):
    """flax ConvTranspose kernel (kh, kw, in, out), applied unflipped ->
    nn.ConvTranspose2d weight (in, out, kh, kw), which torch flips."""
    kernel = np.asarray(leaf["kernel"])[::-1, ::-1]
    _set(deconv.weight, np.transpose(kernel, (2, 3, 0, 1)))
    _set(deconv.bias, leaf["bias"])


def _decoder_subtree(params: dict) -> dict:
    for key in ("params", "decoder"):
        if key in params:
            params = params[key]
    return params


def vae_decoder_from_flax(params: dict, out_hw=(135, 240)):
    """flax DepthVAE / DepthViT / Decoder parameters -> models.vae.Decoder
    (f32, on the CPU) that reconstructs at ``out_hw``."""
    from ..models.vae import Decoder
    p = _decoder_subtree(params)
    dec = Decoder(latent_dim=np.shape(p["Dense_0"]["kernel"])[0], out_hw=out_hw)
    _set_dense(dec.dense0, p["Dense_0"])
    _set_dense(dec.dense1, p["Dense_1"])
    for i, deconv in enumerate(dec.deconvs):
        _set_deconv(deconv, p[f"ConvTranspose_{i}"])
    return dec


def depth_vae_from_flax(params: dict, out_hw=(135, 240)):
    """flax DepthVAE variables -> models.vae.DepthVAE (f32, on the CPU)."""
    from ..models.vae import DepthVAE
    return DepthVAE(encoder=vae_encoder_from_flax(params, out_hw),
                    decoder=vae_decoder_from_flax(params, out_hw))


def depth_vit_from_flax(params: dict, out_hw=(135, 240), attn_impl: str = "fused",
                        remat: bool = False):
    """flax DepthViT variables -> models.vit.DepthViT (f32, on the CPU)."""
    from ..models.vit import DepthViT
    enc = vit_encoder_from_flax(params, attn_impl=attn_impl)
    enc.remat = remat
    return DepthViT(encoder=enc, decoder=vae_decoder_from_flax(params, out_hw))


# the way back: the port's modules -> flax parameter trees (numpy leaves)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy().copy()


def _dense_to_flax(linear, kernel_shape=None, bias_shape=None) -> dict:
    kernel, bias = _np(linear.weight).T, _np(linear.bias)
    return {"kernel": np.ascontiguousarray(kernel.reshape(kernel_shape or kernel.shape)),
            "bias": bias.reshape(bias_shape or bias.shape)}


def _conv_to_flax(conv) -> dict:
    return {"kernel": np.ascontiguousarray(np.transpose(_np(conv.weight), (2, 3, 1, 0))),
            "bias": _np(conv.bias)}


def _deconv_to_flax(deconv) -> dict:
    kernel = np.transpose(_np(deconv.weight), (2, 3, 0, 1))[::-1, ::-1]
    return {"kernel": np.ascontiguousarray(kernel), "bias": _np(deconv.bias)}


def _norm_to_flax(norm) -> dict:
    return {"scale": _np(norm.weight), "bias": _np(norm.bias)}


def vae_decoder_to_flax(dec) -> dict:
    out = {"Dense_0": _dense_to_flax(dec.dense0), "Dense_1": _dense_to_flax(dec.dense1)}
    for i, deconv in enumerate(dec.deconvs):
        out[f"ConvTranspose_{i}"] = _deconv_to_flax(deconv)
    return out


def vae_encoder_to_flax(enc) -> dict:
    out = {f"Conv_{i}": _conv_to_flax(conv) for i, conv in enumerate(enc.convs)}
    out.update(Dense_0=_dense_to_flax(enc.dense0), Dense_1=_dense_to_flax(enc.dense1))
    return out


def vit_encoder_to_flax(enc) -> dict:
    dim = enc.latent_head.in_features
    out = {"patch_embed": _conv_to_flax(enc.patch_embed), "pos_embed": _np(enc.pos_embed)}
    for i, block in enumerate(enc.blocks):
        h = block.attn.num_heads
        hd = dim // h
        attn = {name: _dense_to_flax(getattr(block.attn, name), (dim, h, hd), (h, hd))
                for name in ("query", "key", "value")}
        attn["out"] = _dense_to_flax(block.attn.out, (h, hd, dim))
        out[f"block_{i}"] = {
            "LayerNorm_0": _norm_to_flax(block.norm1), "LayerNorm_1": _norm_to_flax(block.norm2),
            "attn": attn, "mlp_in": _dense_to_flax(block.mlp_in),
            "mlp_out": _dense_to_flax(block.mlp_out)}
    out.update(LayerNorm_0=_norm_to_flax(enc.norm), latent_head=_dense_to_flax(enc.latent_head))
    return out


def depth_vae_to_flax(model) -> dict:
    """models.vae.DepthVAE -> the flax variables dict the JAX package's
    DepthVAE takes ({"params": {"encoder", "decoder"}}, numpy leaves)."""
    return {"params": {"encoder": vae_encoder_to_flax(model.encoder),
                       "decoder": vae_decoder_to_flax(model.decoder)}}


def depth_vit_to_flax(model) -> dict:
    """models.vit.DepthViT -> the flax variables dict of the JAX package's
    DepthViT."""
    return {"params": {"encoder": vit_encoder_to_flax(model.encoder),
                       "decoder": vae_decoder_to_flax(model.decoder)}}


def save_model_pickle(model, path: str):
    """Write a trained autoencoder as the JAX package's ``train_vae`` does:
    the arch-tagged dict for a DepthViT, the bare parameter tree for a
    DepthVAE. ``load_encoder_pickle`` / ``load_model_pickle`` and the JAX
    package's navigation task read either."""
    from ..models.vit import DepthViT
    if isinstance(model, DepthViT):
        enc = model.encoder
        blob = {"arch": "vit", "params": depth_vit_to_flax(model), "patch": tuple(enc.patch),
                "dim": enc.latent_head.in_features, "depth": len(enc.blocks),
                "num_heads": enc.blocks[0].attn.num_heads,
                "attn_impl": enc.blocks[0].attn.impl}
    else:
        blob = depth_vae_to_flax(model)
    with open(path, "wb") as f:
        pickle.dump(blob, f)


def _read_pickle(path: str):
    with open(path, "rb") as f:
        loaded = pickle.load(f)
    is_vit = isinstance(loaded, dict) and loaded.get("arch") == "vit"
    return loaded, is_vit


def _check_vit_tags(path: str, loaded: dict, enc):
    for key, have in (("patch", enc.patch), ("depth", len(enc.blocks)),
                      ("num_heads", enc.blocks[0].attn.num_heads)):
        if key in loaded and tuple(np.atleast_1d(loaded[key])) != tuple(np.atleast_1d(have)):
            raise ValueError(f"{path}: tag says {key}={loaded[key]}, weights say {have}")


def load_encoder_pickle(path: str, input_hw=(135, 240)):
    """Read an encoder checkpoint -> (arch, encoder module). A dict tagged
    {"arch": "vit", "params": ..., "patch", "dim", "depth", "num_heads",
    "attn_impl"} is a ViT encoder; anything else is the conv VAE's raw
    parameter tree."""
    loaded, is_vit = _read_pickle(path)
    if is_vit:
        enc = vit_encoder_from_flax(loaded["params"],
                                    attn_impl=loaded.get("attn_impl", "xla"))
        _check_vit_tags(path, loaded, enc)
        return "vit", enc
    return "conv", vae_encoder_from_flax(loaded, input_hw)


def load_model_pickle(path: str, out_hw=(135, 240)):
    """Read a checkpoint -> (arch, whole autoencoder): a DepthViT for the
    tagged dict, else a DepthVAE; ``out_hw`` is the image size it was
    trained at."""
    loaded, is_vit = _read_pickle(path)
    if is_vit:
        model = depth_vit_from_flax(loaded["params"], out_hw,
                                    attn_impl=loaded.get("attn_impl", "xla"))
        _check_vit_tags(path, loaded, model.encoder)
        return "vit", model
    return "conv", depth_vae_from_flax(loaded, out_hw)
