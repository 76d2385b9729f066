"""Port parity for the deployment surface (``sim2real/``): export, import,
TorchScript and the inference classes, against the JAX package's
(JAX tests/test_aux_utils.py:14-154, :279-417 and the config half of
:439-453).

Tolerances: actions within 1e-5 of the JAX runners on the same archive (the
shipped position, navigation and radar policies and archives written here);
imported archives equal to the JAX importers' key for key; the TorchScript
module within 1e-5 of the module it was scripted from and of the numpy
runner; ``rescale_actions`` within 1e-6. On the imported archives, whose
random weights give actions of a few hundred, 2e-5 plus 1e-5 of the action
(JAX's own import test holds 1e-4 and 1e-5). Inputs come from numpy and
torch seeds.
"""

import os

import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu.sim2real as j_s2r
from aerial_gym_simulator_tpu.sim2real import config as j_config

import aerial_gym_simulator_tpu_torch as port
import aerial_gym_simulator_tpu_torch.sim2real as t_s2r
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from aerial_gym_simulator_tpu_torch.sim2real import config as t_config
from aerial_gym_simulator_tpu_torch.sim2real.policy import MLPPolicy, RecurrentPolicy
from aerial_gym_simulator_tpu_torch.sim2real.torch_export import (
    RecurrentPolicyDeploy, build_deploy_module)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAV = os.path.join(REPO, "examples", "dce_rl_navigation", "selected_network")
SHIPPED = {
    "position": os.path.join(REPO, "aerial_gym_simulator_tpu", "sim2real", "weights",
                             "position_policy.npz"),
    "navigation": os.path.join(NAV, "navigation_policy.npz"),
    "radar": os.path.join(NAV, "radar_navigation_policy.npz"),
}
OBS_DIM = {"position": 13, "navigation": 81, "radar": 337}
ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _obs(n, dim, seed):
    return np.random.RandomState(seed).randn(n, dim).astype(np.float32)


def _position_trainer(**cfg):
    task = port.task_registry.make_task("position_setpoint_task", num_envs=8, seed=0,
                                        device="cpu")
    return PPOTrainer(task, PPOConfig(num_envs=8, horizon=4, minibatch_size=32, seed=0, **cfg))


# -- the package's surface -----------------------------------------------------------


def test_exports_what_the_jax_package_exports():
    assert t_s2r.__all__ == j_s2r.__all__
    for name in t_s2r.__all__:
        assert callable(getattr(t_s2r, name)), name


def test_config_constants_match_jax():
    names = [k for k in vars(j_config) if k.isupper()]
    assert names and all(getattr(t_config, k) == getattr(j_config, k) for k in names)
    assert t_config.TOTAL_IP_DIMS == 17 and t_config.TOTAL_OBS_DIMS == 81


# -- export: the trainer's archive ----------------------------------------------------------


def test_numpy_policy_matches_trainer_and_jax(tmp_path):
    """JAX test_aux_utils.py:14-32: the checkpoint exported to .npz, run by
    the port's NumpyPolicy, equals the trainer's deterministic action and
    the JAX NumpyPolicy on the same archive."""
    trainer = _position_trainer()
    ckpt, npz = str(tmp_path / "p.ckpt"), str(tmp_path / "p.npz")
    trainer.save_checkpoint(ckpt)
    t_s2r.export_policy_npz(ckpt, npz)
    obs = _obs(5, 13, 3)
    a = t_s2r.NumpyPolicy(npz)(obs)
    np.testing.assert_allclose(a, trainer.act(torch.from_numpy(obs)).numpy(), atol=ATOL)
    np.testing.assert_allclose(a, j_s2r.NumpyPolicy(npz)(obs), atol=ATOL)
    assert t_s2r.NumpyPolicy(npz).action_dim == 4
    np.testing.assert_allclose(t_s2r.NumpyPolicy(npz)(obs[0]), a[0], atol=ATOL)


def test_numpy_recurrent_export_matches_trainer_and_jax(tmp_path):
    """JAX test_aux_utils.py:35-66: a GRU checkpoint exports to the
    recurrent archive; NumpyRecurrentPolicy follows trainer.act across
    steps and per-env resets, as JAX's runner does."""
    trainer = _position_trainer(rnn="gru", rnn_hidden=16, hidden=(32, 16))
    ckpt, npz = str(tmp_path / "g.ckpt"), str(tmp_path / "g.npz")
    trainer.save_checkpoint(ckpt)
    t_s2r.export_policy_npz(ckpt, npz)
    policy = t_s2r.NumpyRecurrentPolicy(npz, num_envs=5)
    ref = j_s2r.NumpyRecurrentPolicy(npz, num_envs=5)
    assert policy.recurrent and policy.action_dim == 4
    rng = np.random.RandomState(7)
    dones = None
    for t in range(6):
        obs = rng.randn(5, 13).astype(np.float32)
        a_tr = trainer.act(torch.from_numpy(obs), done_prev=None if dones is None
                           else torch.from_numpy(dones)).numpy()
        if dones is not None:
            policy.reset(np.nonzero(dones)[0])
            ref.reset(np.nonzero(dones)[0])
        a = policy(obs)
        np.testing.assert_allclose(a, a_tr, atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(a, ref(obs), atol=ATOL, err_msg=f"step {t}")
        dones = (rng.rand(5) < 0.3).astype(np.float32)


# -- the shipped archives ----------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_deploy_module_matches_jax_on_shipped_archive(name, tmp_path):
    """build_deploy_module, scripted, saved and loaded, against the JAX
    numpy runner on the shipped archive (20 steps with the hidden state
    carried and one env reset for the GRU) and against the port's loader,
    which the unscripted module repeats bit for bit."""
    npz = SHIPPED[name]
    module = build_deploy_module(npz, device="cpu")
    pt = t_s2r.convert_model_to_script_model(npz, str(tmp_path / f"{name}.pt"))
    scripted = torch.jit.load(pt)
    loaded = t_s2r.load_policy_npz(npz, device="cpu", num_envs=6)
    ref = j_s2r.load_policy_npz(npz, num_envs=6)
    recurrent = isinstance(module, RecurrentPolicyDeploy)
    assert recurrent == (name == "radar")
    assert isinstance(loaded, RecurrentPolicy if recurrent else MLPPolicy)
    h = scripted.initial_state(6) if recurrent else None
    h_mod = module.initial_state(6) if recurrent else None
    for t in range(20 if recurrent else 1):
        obs = _obs(6, OBS_DIM[name], 10 + t)
        x = torch.from_numpy(obs)
        with torch.no_grad():
            if recurrent:
                a_mod, h_mod = module(x, h_mod)
                a_s, h = scripted(x, h)
            else:
                a_mod, a_s = module(x), scripted(x)
        a_ref, a_loaded = ref(obs), loaded(x)
        np.testing.assert_allclose(a_s.numpy(), a_ref, atol=ATOL, err_msg=f"step {t}")
        np.testing.assert_allclose(a_mod.numpy(), a_s.numpy(), atol=ATOL)
        np.testing.assert_allclose(a_loaded.numpy(), a_ref, atol=ATOL)
        # the deploy module runs the runner's operations: the same bits
        assert torch.equal(a_mod, a_loaded), f"step {t}"
        if recurrent and t == 5:
            h, h_mod = h.clone(), h_mod.clone()
            h[2] = h_mod[2] = 0.0
            ref.reset([2])
            loaded.reset([2])


def test_torchscript_round_trip_and_rescale(tmp_path):
    """JAX test_aux_utils.py:69-92: the scripted file runs alone and maps
    [-1, 1] onto the actuator limits (the reference's convert_model.py:29-33)."""
    trainer = _position_trainer()
    ckpt, npz = str(tmp_path / "p.ckpt"), str(tmp_path / "p.npz")
    trainer.save_checkpoint(ckpt)
    t_s2r.export_policy_npz(trainer, npz)
    pt = t_s2r.convert_model_to_script_model(npz, str(tmp_path / "p.pt"),
                                             action_limit_min=[0.2] * 4,
                                             action_limit_max=[1.2] * 4)
    m = torch.jit.load(pt)
    obs = _obs(5, 13, 3)
    np.testing.assert_allclose(m(torch.from_numpy(obs)).detach().numpy(),
                               j_s2r.NumpyPolicy(npz)(obs), atol=ATOL)
    r = m.rescale_actions(torch.tensor([[0.0, 1.0, -1.0, 0.0]])).numpy()[0]
    np.testing.assert_allclose(r, [0.7, 1.2, 0.2, 0.7], atol=1e-6)
    assert m.norm_mean.device.type == "cpu"          # the file is saved from the CPU
    with pytest.raises(ValueError, match="both"):
        t_s2r.convert_model_to_script_model(npz, str(tmp_path / "q.pt"),
                                            action_limit_min=[0.0] * 4)


def test_recurrent_torchscript_tracks_numpy_runner(tmp_path):
    """JAX test_aux_utils.py:95-128: a GRU archive scripts to a module with
    an explicit hidden state that follows the numpy runner across steps and
    a reset."""
    trainer = _position_trainer(rnn="gru", rnn_hidden=16, hidden=(32, 16))
    npz = t_s2r.export_policy_npz(trainer, str(tmp_path / "g.npz"))
    m = torch.jit.load(t_s2r.convert_model_to_script_model(npz, str(tmp_path / "g.pt")))
    ref = j_s2r.load_policy_npz(npz, num_envs=5)
    rng = np.random.RandomState(7)
    h = m.initial_state(5)
    for t in range(6):
        obs = rng.randn(5, 13).astype(np.float32)
        a, h = m(torch.from_numpy(obs), h)
        np.testing.assert_allclose(a.detach().numpy(), ref(obs), atol=ATOL, err_msg=f"step {t}")
        if t == 2:
            ref.reset([1])
            h = h.clone()
            h[1] = 0.0


# -- the inference classes -------------------------------------------------------------


def test_sim2real_inference_class_both_ways(tmp_path):
    """JAX test_aux_utils.py:131-147 on a training checkpoint (converted on
    load): numpy actions, a tensor on the policy's device with
    get_np=False, one robot's action with get_robot_zero, and JAX's class
    on the same checkpoint's archive."""
    trainer = _position_trainer()
    ckpt = str(tmp_path / "c.ckpt")
    trainer.save_checkpoint(ckpt)
    inf = t_s2r.Sim2RealInferenceClass(num_envs=1, num_actions=4, num_obs=13,
                                       checkpoint_path=ckpt, device="cpu")
    assert os.path.exists(ckpt + ".npz")
    obs = _obs(1, 13, 4)
    a = inf.get_action(obs)
    assert isinstance(a, np.ndarray) and a.shape == (1, 4)
    t = inf.get_action(torch.from_numpy(obs), get_np=False)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    np.testing.assert_allclose(t.numpy(), a, atol=0)
    a0 = inf.get_action(obs[0], get_robot_zero=True)
    assert a0.shape == (4,)
    ref = j_s2r.Sim2RealInferenceClass(num_envs=1, num_actions=4, num_obs=13,
                                       checkpoint_path=ckpt + ".npz")
    np.testing.assert_allclose(a, ref.get_action(obs), atol=ATOL)


def test_rl_nav_interface_matches_jax_on_shipped_policy():
    """RL_Nav_Interface on the shipped navigation policy, against JAX's."""
    obs = _obs(3, 81, 5)
    nav = t_s2r.RL_Nav_Interface(num_envs=3, checkpoint_path=SHIPPED["navigation"],
                                 device="cpu")
    ref = j_s2r.RL_Nav_Interface(num_envs=3, checkpoint_path=SHIPPED["navigation"])
    np.testing.assert_allclose(nav.step({"observations": obs}),
                               ref.step({"observations": obs}), atol=ATOL)
    nav.reset()


@pytest.mark.parametrize("make", [
    lambda: build_deploy_module(SHIPPED["position"]),
    lambda: t_s2r.Sim2RealInferenceClass(1, 4, 13, SHIPPED["position"]),
    lambda: t_s2r.RL_Nav_Interface(1, SHIPPED["navigation"]),
], ids=["build_deploy_module", "Sim2RealInferenceClass", "RL_Nav_Interface"])
def test_entry_points_run_on_cuda_unless_asked_for_the_cpu(make):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()


# -- import: the reference framework's checkpoints ------------------------------------------


def _rl_games_state_dict(obs_dim=13, act_dim=4, seed=3, normalizer=True):
    g = torch.Generator().manual_seed(seed)
    dims = [obs_dim, 32, 16, act_dim]
    sd = {}
    for j, i in enumerate((0, 2)):
        sd[f"a2c_network.actor_mlp.{i}.weight"] = torch.randn(dims[j + 1], dims[j], generator=g)
        sd[f"a2c_network.actor_mlp.{i}.bias"] = torch.randn(dims[j + 1], generator=g)
    sd["a2c_network.mu.weight"] = torch.randn(act_dim, 16, generator=g)
    sd["a2c_network.mu.bias"] = torch.randn(act_dim, generator=g)
    sd["a2c_network.sigma"] = torch.zeros(act_dim)
    if normalizer:
        sd["running_mean_std.running_mean"] = torch.randn(obs_dim, generator=g)
        sd["running_mean_std.running_var"] = torch.rand(obs_dim, generator=g) + 0.5
    return sd


def _sample_factory_state_dict(obs_dim=9, hid=8, head=8, seed=5, gru=True, normalizer=False):
    g = torch.Generator().manual_seed(seed)
    sd = {"encoder.encoders.obs.mlp_head.0.weight": torch.randn(hid, obs_dim, generator=g),
          "encoder.encoders.obs.mlp_head.0.bias": torch.randn(hid, generator=g),
          "encoder.encoders.obs.mlp_head.2.weight": torch.randn(hid, hid, generator=g),
          "encoder.encoders.obs.mlp_head.2.bias": torch.randn(hid, generator=g)}
    if gru:
        sd.update({"core.core.weight_ih_l0": torch.randn(3 * hid, hid, generator=g),
                   "core.core.weight_hh_l0": torch.randn(3 * hid, hid, generator=g),
                   "core.core.bias_ih_l0": torch.randn(3 * hid, generator=g),
                   "core.core.bias_hh_l0": torch.randn(3 * hid, generator=g)})
    sd["action_parameterization.distribution_linear.weight"] = torch.randn(head, hid,
                                                                            generator=g)
    sd["action_parameterization.distribution_linear.bias"] = torch.randn(head, generator=g)
    if normalizer:
        p = "obs_normalizer.running_mean_std.running_mean_std.obs."
        sd[p + "running_mean"] = torch.randn(obs_dim, generator=g)
        sd[p + "running_var"] = torch.rand(obs_dim, generator=g) + 0.5
    return sd


IMPORT_CASES = {
    "rl_games": ("import_rl_games_policy", lambda: _rl_games_state_dict(), 13),
    "rl_games_no_normalizer": ("import_rl_games_policy",
                               lambda: _rl_games_state_dict(normalizer=False), 13),
    "sample_factory_gru": ("import_sample_factory_policy",
                           lambda: _sample_factory_state_dict(normalizer=True), 9),
    "sample_factory_feed_forward": ("import_sample_factory_policy",
                                    lambda: _sample_factory_state_dict(gru=False), 9),
    "sample_factory_mu_only": ("import_sample_factory_policy",
                               lambda: _sample_factory_state_dict(head=4), 9),
}


@pytest.mark.parametrize("case", sorted(IMPORT_CASES))
def test_importer_archive_equals_jax_and_every_runner_opens_it(case, tmp_path):
    """The port's importer writes the JAX importer's archive key for key
    (state dicts built here from a seed, saved as {"model": sd}); the
    port's loader, deploy module and numpy runners then act alike on it,
    and as JAX's runner: enc_W*/head without a GRU, a mu-only head (its
    width from action_dim), no activation key, no norm_eps (1e-5)."""
    fn, make_sd, obs_dim = IMPORT_CASES[case]
    pth = str(tmp_path / "m.pth")
    torch.save({"model": make_sd()}, pth)
    t_npz, j_npz = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    getattr(t_s2r, fn)(pth, t_npz)
    getattr(j_s2r, fn)(pth, j_npz)
    with np.load(t_npz) as t, np.load(j_npz) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            assert t[k].dtype == j[k].dtype, k
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)

    n, act = 3, 4
    ref = j_s2r.load_policy_npz(j_npz, num_envs=n, action_dim=act)
    loaded = t_s2r.load_policy_npz(t_npz, device="cpu", num_envs=n, action_dim=act)
    module = build_deploy_module(t_npz, action_dim=act, device="cpu")
    numpy_runner = (t_s2r.NumpyPolicy(t_npz) if fn == "import_rl_games_policy"
                    else t_s2r.NumpyRecurrentPolicy(t_npz, num_envs=n, action_dim=act))
    h = module.initial_state(n) if isinstance(module, RecurrentPolicyDeploy) else None
    for step in range(3):
        obs = _obs(n, obs_dim, 20 + step)
        a_ref = ref(obs)
        assert a_ref.shape == (n, act)
        with torch.no_grad():
            if h is None:
                a_mod = module(torch.from_numpy(obs))
            else:
                a_mod, h = module(torch.from_numpy(obs), h)
        tol = dict(atol=2e-5, rtol=1e-5, err_msg=f"step {step}")
        np.testing.assert_allclose(a_mod.numpy(), a_ref, **tol)
        np.testing.assert_allclose(loaded(torch.from_numpy(obs)).numpy(), a_ref, **tol)
        np.testing.assert_allclose(numpy_runner(obs), a_ref, **tol)


def test_sample_factory_import_matches_torch_gru(tmp_path):
    """JAX test_aux_utils.py:303-353: the imported GRU follows torch.nn.GRU
    across carried steps; reset() zeroes one env."""
    sd = _sample_factory_state_dict(head=8)
    pth, npz = str(tmp_path / "sf.pth"), str(tmp_path / "sf.npz")
    torch.save({"model": sd}, pth)
    t_s2r.import_sample_factory_policy(pth, npz)
    pol = t_s2r.NumpyRecurrentPolicy(npz, num_envs=3)
    assert pol.action_dim == 4 and pol.recurrent
    gru = torch.nn.GRU(8, 8)
    with torch.no_grad():
        for name in ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0", "bias_hh_l0"):
            getattr(gru, name).copy_(sd[f"core.core.{name}"])
    obs = _obs(3, 9, 2)
    F = torch.nn.functional
    with torch.no_grad():
        x = torch.from_numpy(obs)
        for i in (0, 2):
            x = F.elu(F.linear(x, sd[f"encoder.encoders.obs.mlp_head.{i}.weight"],
                               sd[f"encoder.encoders.obs.mlp_head.{i}.bias"]))
        h = torch.zeros(1, 3, 8)
        for _ in range(3):
            out, h = gru(x[None], h)
            mu = F.linear(out[0], sd["action_parameterization.distribution_linear.weight"],
                          sd["action_parameterization.distribution_linear.bias"])[:, :4]
            np.testing.assert_allclose(pol(obs), mu.numpy(), atol=2e-5)
    pol.reset([1])
    fresh = t_s2r.NumpyRecurrentPolicy(npz, num_envs=3)
    np.testing.assert_allclose(pol(obs)[1], fresh(obs)[1], atol=2e-5)


def test_pth_is_read_without_code(tmp_path):
    """A .pth holding a pickled module (code) is refused: weights_only."""
    pth = str(tmp_path / "module.pth")
    torch.save(torch.nn.Linear(2, 2), pth)
    with pytest.raises(Exception):
        t_s2r.import_rl_games_policy(pth, str(tmp_path / "x.npz"))
