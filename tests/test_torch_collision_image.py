"""Port parity for the collision-label render (``utils/
collision_image_generator``): ``inflate_scene`` on the obstacle scene,
``render_inflated_depth`` from a state carried across from the JAX package,
``train_vae.sample_batch``'s collision targets against the JAX function on
the same teleported state, and one ``train_vae --collision_targets`` step.

Tolerances: the inflated sizes exactly (the same f32 additions). Depth atol
1e-4 and segmentation exactly on the rays where both packages hit the same
primitive, which must be more than 99.9% of the rays: the port packs
world-frame primitive tables while the JAX oracle works in each asset's
frame, so the two round differently (~1e-6 m), and a ray that grazes an
edge can hit in one and miss in the other (tests/test_torch_raycast.py).
Targets (depth over the camera range, clipped and resized) 1e-5 on the
same rays.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.config.sensor_config import sensor_configs as j_cfgs
from aerial_gym_simulator_tpu.sensors import raycast_sensor as j_rs
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder
from aerial_gym_simulator_tpu.utils import collision_image_generator as j_cig

from aerial_gym_simulator_tpu_torch.models import train_vae
from aerial_gym_simulator_tpu_torch.sim.convert import (
    params_from_numpy, record_to_numpy, state_from_numpy)
from aerial_gym_simulator_tpu_torch.utils import collision_image_generator as t_cig

N = 3
CAM = dict(height=27, width=48)
AGREE = 0.999


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """The plain ray cast and the training step are many small eager ops:
    one torch thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def carried():
    """The JAX training env (obstacles, camera quad) with a small camera,
    and the port's copy of its params and state."""
    jenv = JSimBuilder().build_env("base_sim", "env_with_obstacles",
                                   "base_quadrotor_with_camera", "lee_velocity_control",
                                   num_envs=N, seed=7)
    jenv.reset()
    jp = jenv.params.replace(camera=j_rs.build_ray_sensor_params(
        j_cfgs.BaseDepthCameraConfig(**CAM)))
    js = jenv.state
    tp = params_from_numpy(record_to_numpy(jp), "cpu")
    ts = state_from_numpy(record_to_numpy(js), "cpu", seed=7)
    return jp, js, tp, ts


def _assert_renders_match(got, want):
    depth, seg = (x.numpy() for x in got)
    d_ref, s_ref = (np.asarray(x) for x in want)
    assert depth.shape == d_ref.shape == (N, CAM["height"], CAM["width"])
    hit, hit_ref = s_ref != -2, seg != -2
    same = (hit == hit_ref) & (seg == s_ref) & (np.abs(depth - d_ref) <= 1e-4)
    assert same.mean() > AGREE, same.mean()
    assert hit.any()
    return same


def test_inflate_scene_matches_jax(carried):
    jp, js, tp, ts = carried
    r = float(jp.robot.collision_radius)
    assert r > 0 and r == tp.robot.collision_radius
    j_sc = j_cig.inflate_scene(jp.scene, r)
    t_sc = t_cig.inflate_scene(tp.scene, r)
    np.testing.assert_array_equal(t_sc.env_prim_size.numpy(), np.asarray(j_sc.env_prim_size))
    kinds = tp.scene.env_prim_kind
    grown = t_sc.env_prim_size - tp.scene.env_prim_size
    assert torch.allclose(grown[kinds == 0], torch.tensor(2 * r), atol=1e-6)
    assert (kinds == 0).any() and torch.equal(t_sc.env_prim_pos, tp.scene.env_prim_pos)
    assert torch.equal(tp.scene.env_prim_size, params_from_numpy(
        record_to_numpy(jp), "cpu").scene.env_prim_size)          # the input is untouched


@pytest.mark.parametrize("radius", [None, 0.5])
def test_render_inflated_depth_matches_jax(carried, radius):
    jp, js, tp, ts = carried
    want = jax.jit(lambda s: j_cig.render_inflated_depth(jp, s, radius))(js)
    got = t_cig.render_inflated_depth(tp, ts, radius)
    _assert_renders_match(got, want)
    assert got[1].dtype == torch.int32
    # inflating brings every hit closer
    raw = t_cig.render_inflated_depth(tp, ts, 0.0)[0]
    assert (got[0] <= raw + 1e-4).all() and (got[0] < raw - 1e-3).any()


def test_inflated_cast_inputs_are_what_render_inflated_depth_casts(carried):
    """The packed inflated table: the raw scene's table with the grown
    sizes, and its plain ray cast is render_inflated_depth's output."""
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import cast_inputs
    jp, js, tp, ts = carried
    inputs, n_tri = t_cig.inflated_cast_inputs(tp, ts, 0.25)
    raw = cast_inputs(tp, ts, tp.camera, ts.cam_mount_pos, ts.cam_mount_quat)
    assert n_tri == tp.scene.n_tri and len(inputs) == len(raw)
    assert torch.equal(inputs[0], raw[0]) and inputs[4:] == raw[4:]
    assert not torch.equal(inputs[1], raw[1])
    d, s = rc.raycast_reference(*inputs, n_tri=n_tri)
    depth, seg = t_cig.render_inflated_depth(tp, ts, 0.25)
    assert torch.equal(depth.reshape(d.shape), d) and torch.equal(seg.reshape(s.shape), s)


def test_collision_targets_match_jax(carried):
    """sample_batch teleports the robots from the port's generator; the JAX
    function renders the same teleported state, and its targets (depth over
    the camera's range, clipped, resized by nearest neighbour) are the
    port's."""
    jp, js, tp, ts = carried
    hw = (18, 32)
    state, inputs, targets = train_vae.sample_batch(tp, ts, hw, collision_targets=True)
    assert tuple(targets.shape) == (N, *hw, 1) and not torch.equal(targets, inputs)
    js2 = js.replace(**{f: jnp.asarray(getattr(state, f).numpy()) for f in (
        "pos", "quat", "obstacle_pos", "obstacle_quat", "cam_mount_pos", "cam_mount_quat")})
    infl, seg = j_cig.render_inflated_depth(jp, js2)
    same = _assert_renders_match(t_cig.render_inflated_depth(tp, state), (infl, seg))
    infl = jnp.clip(infl / float(jp.camera.max_range), 0.0, 1.0)
    want = np.asarray(jnp.clip(jax.image.resize(infl[..., None], (N, *hw, 1), "nearest"),
                               0.0, 1.0))
    want_same = np.asarray(jax.image.resize(jnp.asarray(same, jnp.float32)[..., None],
                                            (N, *hw, 1), "nearest")) > 0.5
    got = targets.numpy()
    assert want_same.mean() > 0.99
    np.testing.assert_allclose(got[want_same], want[want_same], atol=1e-5, rtol=0)
    assert got.min() >= 0.0 and got.max() <= 1.0


def test_train_vae_collision_targets_step_on_cpu(tmp_path):
    out = str(tmp_path / "collision_vae.pkl")
    args = train_vae.build_parser().parse_args([
        "--arch", "conv", "--collision_targets", "--steps", "1", "--batch", "2",
        "--image_h", "36", "--image_w", "48", "--latent_dim", "8", "--device", "cpu",
        "--log_every", "1", "--out", out])
    model, history = train_vae.train(args)
    assert len(history) == 1 and np.isfinite(history[0]["loss"])
    train_vae.main(["--arch", "vit", "--vit_dim", "16", "--vit_depth", "1", "--vit_heads", "2",
                    "--collision_targets", "--steps", "1", "--batch", "2", "--image_h", "36",
                    "--image_w", "48", "--latent_dim", "8", "--device", "cpu", "--out", out])
