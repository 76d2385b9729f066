"""Port parity for the training plumbing: the rl-games YAML mapping, the
curriculum manager, the metrics writer, the sample-factory adapter's data
and hooks, the custom task and the reference-VAE importer, against the JAX
package on the same inputs; then the ``rl.ppo`` command line, the YAML
runner, the CleanRL script and the vec-env wrappers on the CPU.

Tolerances: the configs, the curriculum sequence and the metrics lines are
equal (the lines byte for byte); a custom-task step from a state carried
across 1e-4 (as tests/test_torch_position_task.py: one physics substep, the
same formulas in another summation order); the imported VAE's encoder and
decoder against the JAX package's parity modules on one seeded state dict
1e-5 (f32 convolutions, summed in another order).
"""

import argparse
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu as ag
from aerial_gym_simulator_tpu.models import torch_vae_import as j_vae
from aerial_gym_simulator_tpu.rl_training.rl_games import runner as j_runner
from aerial_gym_simulator_tpu.rl_training.sample_factory import aerialgym_env as j_sf
from aerial_gym_simulator_tpu.tasks.custom_task import CustomTask as JCustomTask
from aerial_gym_simulator_tpu.tasks.custom_task import CustomTaskConfig as JCustomTaskConfig
from aerial_gym_simulator_tpu.utils.curriculum_manager import CurriculumManager as JCurriculum
from aerial_gym_simulator_tpu.utils.metrics import MetricsWriter as JMetricsWriter

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig)
from aerial_gym_simulator_tpu_torch.models import torch_vae_import as t_vae
from aerial_gym_simulator_tpu_torch.rl import ppo as t_ppo
from aerial_gym_simulator_tpu_torch.rl_training import vec_env
from aerial_gym_simulator_tpu_torch.rl_training.cleanrl import ppo_continuous_action
from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner as t_runner
from aerial_gym_simulator_tpu_torch.rl_training.sample_factory import aerialgym_env as t_sf
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.sim2real.policy import export_policy_npz, load_policy_npz
from aerial_gym_simulator_tpu_torch.tasks.custom_task import CustomTask, CustomTaskConfig
from aerial_gym_simulator_tpu_torch.utils.curriculum_manager import CurriculumManager
from aerial_gym_simulator_tpu_torch.utils.metrics import MetricsWriter

# the JAX learner's metrics (rl/ppo.py _rollout_metrics) and train()'s keys
JAX_HISTORY_KEYS = {"reward_mean", "done_rate", "crash_rate", "pg_loss", "v_loss", "entropy",
                    "approx_kl", "lr", "value_mean", "iter", "env_steps", "wall_s",
                    "env_steps_per_s_cumulative", "env_steps_per_s"}


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run thousands of tiny eager ops; torch's intra-op threads
    buy them nothing and, when several test workers share the cores, their
    spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["ppo_aerial_quad.yaml", "ppo_aerial_quad_navigation.yaml"])
def test_yaml_configs_map_like_jax(name):
    with open(os.path.join(j_runner.CONFIG_DIR, name)) as a, \
            open(os.path.join(t_runner.CONFIG_DIR, name)) as b:
        assert a.read() == b.read()
    doc = t_runner.load_yaml_config(os.path.join(t_runner.CONFIG_DIR, name))
    for kw in ({}, {"num_envs": 64, "seed": 5}):
        ours = dataclasses.asdict(t_runner.ppo_config_from_yaml(doc, **kw))
        theirs = dataclasses.asdict(j_runner.ppo_config_from_yaml(doc, **kw))
        # the port maps rl-games' rnn.layer_norm, which the JAX runner drops
        assert ours.pop("rnn_layer_norm") is (name == "ppo_aerial_quad_navigation.yaml")
        assert ours == theirs
    for value in (None, "adaptive"):
        assert t_runner._map_lr_schedule(value) == j_runner._map_lr_schedule(value)
    with pytest.warns(UserWarning, match="linear"):
        assert t_runner._map_lr_schedule("linear") == "fixed"


def test_curriculum_manager_matches_jax():
    ours = CurriculumManager(num_envs=4, min_level=3, max_level=11, level_step=2)
    theirs = JCurriculum(num_envs=4, min_level=3, max_level=11, level_step=2)
    assert ours.level_list == theirs.level_list
    for up in [1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 1, 1]:   # up, down, both clamps
        for m in (ours, theirs):
            m.increase_curriculum_level() if up else m.decrease_curriculum_level()
        assert ours.get_current_level() == theirs.get_current_level()
        assert ours.max_level_obtained == theirs.max_level_obtained


def test_metrics_lines_match_jax(tmp_path):
    writes = [(0, {"reward_mean": 1.25, "iter": 0, "lr": np.float32(3e-4)}),
              (4096, {"reward_mean": torch.tensor(-0.5), "iter": 1, "wall_s": 0.1 + 0.2})]
    for cls, d in ((JMetricsWriter, "jax"), (MetricsWriter, "port")):
        with cls(str(tmp_path / d)) as w:
            for step, m in writes:
                w.write(step, m)
    ours = (tmp_path / "port" / "metrics.jsonl").read_bytes()
    assert ours == (tmp_path / "jax" / "metrics.jsonl").read_bytes()
    assert len(ours.splitlines()) == 2
    off = MetricsWriter(None)
    assert not off.enabled
    off.write(1, {"x": 1.0})
    off.close()


def _sf_parser():
    """The parser sample-factory would build, with the adapter's hooks."""
    parser = argparse.ArgumentParser()
    for key, val in t_sf.SF_BASE_DEFAULTS.items():
        parser.add_argument(f"--{key}", default=None,
                            type=type(val) if not isinstance(val, bool)
                            else lambda s: s == "True")
    for key in ("encoder_mlp_layers", "rnn_num_layers", "rnn_size", "rnn_type", "env",
                "experiment"):
        parser.add_argument(f"--{key}", default=None)
    parser.add_argument("--device", default="cpu")      # sample-factory's own flag
    t_sf.add_extra_params_func(parser)
    return parser


def test_sample_factory_data_and_hooks_match_jax():
    assert t_sf.SF_BASE_DEFAULTS == j_sf.SF_BASE_DEFAULTS
    assert t_sf.SF_ENV_CONFIGS == j_sf.SF_ENV_CONFIGS
    for env in ("position_setpoint_task", "lidar_navigation_task", "custom"):
        parsers = []
        for mod in (t_sf, j_sf):
            parser = argparse.ArgumentParser()
            for key in list(t_sf.SF_BASE_DEFAULTS) + ["encoder_mlp_layers", "rnn_num_layers",
                                                      "rnn_size", "rnn_type"]:
                parser.add_argument(f"--{key}", default=None)
            mod.add_extra_params_func(parser)
            mod.override_default_params_func(env, parser)
            parsers.append(vars(parser.parse_args([])))
        assert parsers[0] == parsers[1], env
    args = vars(_sf_parser().parse_args([]))
    assert args["env_agents"] == -1 and args["obs_key"] == "obs"


def test_sample_factory_registration(monkeypatch):
    registered = {}
    monkeypatch.setattr(t_sf, "HAVE_SAMPLE_FACTORY", True)
    monkeypatch.setattr(t_sf, "register_env",
                        lambda name, fn: registered.__setitem__(name, fn), raising=False)
    t_sf.register_aerialgym_custom_components()
    assert set(registered) == set(port.task_registry.get_task_names())
    assert all(fn is t_sf.make_aerialgym_env for fn in registered.values())
    monkeypatch.setattr(t_sf, "HAVE_SAMPLE_FACTORY", False)
    with pytest.raises(ImportError, match="sample-factory is not installed"):
        t_sf.register_aerialgym_custom_components()


def test_sample_factory_transcript_replays_against_the_port():
    """tests/data/sf_protocol_transcript.json, the pinned sample-factory
    protocol, replayed against the port's AerialGymVecEnv: the resolved
    cfg, the per-agent spaces and the call sequence with its dtypes and
    shapes, torch-tensor actions included."""
    path = os.path.join(os.path.dirname(__file__), "data", "sf_protocol_transcript.json")
    with open(path) as f:
        tr = json.load(f)
    parser = _sf_parser()
    env_name = [a.split("=", 1)[1] for a in tr["argv"] if a.startswith("--env=")][0]
    t_sf.override_default_params_func(env_name, parser)
    cfg = parser.parse_args(tr["argv"])
    for key, want in tr["resolved_cfg"].items():
        got = getattr(cfg, key)
        assert got == want or str(got) == str(want), (key, got, want)

    env = t_sf.make_aerialgym_env(env_name, cfg=cfg)
    ec = tr["env_contract"]
    assert env.num_agents == ec["num_agents"]
    assert sorted(env.observation_space.spaces) == ec["observation_space"]["keys"]
    box = env.observation_space["obs"]
    assert list(box.shape) == ec["observation_space"]["obs"]["shape"]
    assert str(box.dtype) == ec["observation_space"]["obs"]["dtype"]
    assert list(env.action_space.shape) == ec["action_space"]["shape"]
    assert float(env.action_space.low.min()) == ec["action_space"]["low"]
    assert float(env.action_space.high.max()) == ec["action_space"]["high"]
    assert hasattr(env, "render_mode")

    def check_obs(obs, want):
        assert sorted(obs.keys()) == want["keys"]
        assert list(obs["obs"].shape) == want["obs_shape"]
        assert str(obs["obs"].dtype) == want["obs_dtype"]

    for call in tr["calls"]:
        want = call.get("returns", {})
        if call["call"] == "reset":
            out = env.reset(**call.get("kwargs", {}))
            assert len(out) == want["tuple_len"]
            check_obs(out[0], want["obs"])
            assert type(out[1]).__name__ == want["info_type"]
        elif call["call"] == "step":
            spec = call["actions"]
            for _ in range(call.get("repeat", 1)):
                if spec["kind"] == "torch":
                    actions = torch.zeros(tuple(spec["shape"]), dtype=torch.float32)
                else:
                    actions = np.zeros(tuple(spec["shape"]), dtype=spec["dtype"])
                out = env.step(actions)
                assert len(out) == want["tuple_len"]
                obs, rew, term, trunc, _ = out
                check_obs(obs, want["obs"])
                assert list(rew.shape) == want["rew"]["shape"]
                assert str(rew.dtype) == want["rew"]["dtype"]
                assert str(term.dtype) == want["terminated"]["dtype"]
                assert str(trunc.dtype) == want["truncated"]["dtype"]
                assert (term | trunc).dtype == np.bool_
        elif call["call"] == "close":
            env.close()


def test_custom_task_step_matches_jax():
    """One step of the template from a state carried across."""
    n = 4
    jt = JCustomTask(JCustomTaskConfig(num_envs=n, seed=3))
    tt = CustomTask(CustomTaskConfig(num_envs=n, seed=3), device="cpu")
    jt.reset()
    tt.reset()
    rs = np.random.RandomState(4)
    a = rs.uniform(-1, 1, (n, 4)).astype(np.float32)
    for _ in range(3):
        jt.step(jnp.asarray(a))
    tt.sim_env.state = state_from_numpy(record_to_numpy(jt.state), "cpu", seed=3)
    a = rs.uniform(-1, 1, (n, 4)).astype(np.float32)
    j_obs, j_rew, j_term, j_trunc, _ = jt.step(jnp.asarray(a))
    t_obs, t_rew, t_term, t_trunc, _ = tt.step(torch.from_numpy(a))
    np.testing.assert_allclose(t_obs["observations"].numpy(),
                               np.asarray(j_obs["observations"]), atol=1e-4)
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), atol=1e-4)
    assert np.array_equal(t_term.numpy(), np.asarray(j_term))
    assert np.array_equal(t_trunc.numpy(), np.asarray(j_trunc))
    assert "custom_task" not in port.task_registry.get_task_names()      # unregistered


@pytest.fixture(scope="module")
def reference_vae(tmp_path_factory):
    """A reference-layout VAE state dict from a seed, saved as a .pth with
    the reference's attribute names and a DataParallel prefix on some keys."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        enc, dec = t_vae.ImgEncoder(), t_vae.ImgDecoder()
    sd = {f"module.encoder.{k}": v for k, v in enc.state_dict().items()}
    sd.update({f"img_decoder.{k}": v for k, v in dec.state_dict().items()})
    path = str(tmp_path_factory.mktemp("vae") / "vae.pth")
    torch.save(sd, path)
    return sd, path


def test_torch_vae_import_matches_jax(reference_vae):
    sd, _ = reference_vae
    enc_sd, dec_sd = t_vae.convert_torch_vae_state_dict(sd)
    enc, dec = t_vae.ImgEncoder(), t_vae.ImgDecoder()
    enc.load_state_dict(enc_sd)
    dec.load_state_dict(dec_sd)
    j_enc, j_dec = j_vae.convert_torch_vae_state_dict(sd)
    x = np.random.RandomState(0).rand(2, 270, 480).astype(np.float32)
    z = np.random.RandomState(1).randn(2, 64).astype(np.float32)
    with torch.no_grad():
        t_out = enc(torch.from_numpy(x)[:, None]).numpy()
        t_img = dec(torch.from_numpy(z)).numpy()
    j_out = np.asarray(j_vae.TorchParityEncoder().apply(j_enc, jnp.asarray(x)[..., None]))
    j_img = np.asarray(j_vae.TorchParityDecoder().apply(j_dec, jnp.asarray(z)))
    np.testing.assert_allclose(t_out, j_out, atol=1e-5)
    assert t_img.shape == (2, 1, 270, 480)
    np.testing.assert_allclose(t_img[:, 0], j_img[..., 0], atol=1e-5)


def test_torch_vae_encoder_wrapper_matches_jax(reference_vae):
    """TorchVAEImageEncoder on task-resolution depth (135x240, resized to
    270x480): the mean latent against the JAX package's wrapper; decode's
    shape."""
    _, path = reference_vae
    ours = t_vae.TorchVAEImageEncoder(path, device="cpu")
    theirs = j_vae.TorchVAEImageEncoder(path)
    img = np.random.RandomState(2).rand(3, 135, 240).astype(np.float32)
    lat = ours.encode(torch.from_numpy(img))
    np.testing.assert_allclose(lat.numpy(), np.asarray(theirs.encode(jnp.asarray(img))),
                               atol=1e-5)
    assert ours.decode(lat).shape == (3, 270, 480, 1)


def test_navigation_task_flies_the_reference_vae(reference_vae):
    _, path = reference_vae
    cfg = dataclasses.replace(port.task_registry.get_task_config("navigation_task"),
                              torch_vae_path=path)
    task = port.task_registry.make_task("navigation_task", num_envs=2, seed=4, task_config=cfg,
                                        device="cpu")
    assert isinstance(task.vae, t_vae.TorchVAEImageEncoder)
    task.params = replace(task.params, camera=build_ray_sensor_params(
        BaseDepthCameraConfig(height=12, width=16), "cpu"))
    task.reset()
    for _ in range(2):
        obs, rew, *_ = task.step(torch.zeros((2, 4)))
    assert obs["observations"].shape == (2, 81) and torch.isfinite(obs["observations"]).all()
    assert torch.isfinite(rew).all() and task.nav_state.latents.abs().sum() > 0
    task.close()


# ---------------------------------------------------------------------------
# the command line, the runners, the wrappers
# ---------------------------------------------------------------------------

CLI = ["--cpu", "--num_envs", "16", "--horizon", "8", "--seed", "3"]


def test_cli_trains_saves_and_logs(tmp_path, capsys):
    logdir, save = str(tmp_path / "logs"), str(tmp_path / "policy.ckpt")
    history = t_ppo.main(CLI + ["--total_steps", "256", "--logdir", logdir, "--save", save])
    assert [m["iter"] for m in history] == [0, 1]
    assert "final reward:" in capsys.readouterr().out
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    assert [m["step"] for m in lines] == [128, 256]
    assert set(lines[0]) == JAX_HISTORY_KEYS | {"step"}
    npz = export_policy_npz(save, str(tmp_path / "policy.npz"))
    policy = load_policy_npz(npz, device="cpu")
    assert torch.isfinite(policy(torch.zeros((16, 13)))).all()


@pytest.mark.parametrize("flag", ["--multichip", "--multihost"])
def test_cli_refuses_multi_device_training(flag, monkeypatch):
    """Outside a process group: --multichip trains as a world of one (the
    unsharded trainer), --multihost is refused (no coordinator). The sharded
    runs are in tests/test_torch_parallel.py."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    args = t_ppo.parse_args(CLI + [flag])
    if flag == "--multihost":
        with pytest.raises(RuntimeError, match="no coordinator"):
            t_ppo.build_trainer(args)
        return
    task, trainer = t_ppo.build_trainer(args)
    assert trainer.shard is None and trainer.env_carry.pos.shape[0] == 16


def test_cli_task_kv(capsys):
    args = t_ppo.parse_args(CLI + ["--task_kv", "episode_len_steps=20",
                                   "--task_kv", "robot_name=lmf2"])
    assert args.task_overrides == {"episode_len_steps": 20, "robot_name": "lmf2"}
    with pytest.raises(SystemExit) as e:
        t_ppo.parse_args(CLI + ["--task_kv", "no_such_field=1"])
    assert e.value.code == 2 and "no_such_field" in capsys.readouterr().err
    task, trainer = t_ppo.build_trainer(t_ppo.parse_args(
        CLI + ["--task_kv", "episode_len_steps=20", "--rnn", "gru", "--rnn_hidden", "8"]))
    assert task.task_config.episode_len_steps == 20 and trainer.cfg.rnn == "gru"
    assert task.device.type == "cpu" and trainer.cfg.minibatch_size == 128
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            t_ppo.build_trainer(t_ppo.parse_args(CLI[1:]))


def test_cli_resume_of_a_finished_run_returns_at_once(tmp_path, capsys):
    ckpt = ["--ckpt_dir", str(tmp_path / "ckpt"), "--save_every", "1", "--total_steps", "256"]
    assert len(t_ppo.main(CLI + ckpt)) == 2
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["iter_1.pt", "iter_2.pt"]
    capsys.readouterr()
    assert t_ppo.main(CLI + ckpt + ["--resume"]) == []
    assert "nothing to train" in capsys.readouterr().out


def test_yaml_runner_trains_then_plays(tmp_path, capsys):
    ckpt = str(tmp_path / "runner.ckpt")
    out = t_runner.main(["--cpu", "--num_envs", "8", "--total_steps", "256", "--seed", "1",
                         "--checkpoint", ckpt])
    assert out["checkpoint"] == ckpt and os.path.exists(ckpt)
    assert len(out["history"]) == 1 and "train done" in capsys.readouterr().out
    out = t_runner.main(["--cpu", "--play", "--num_envs", "8", "--play_steps", "5",
                         "--checkpoint", ckpt])
    assert np.isfinite(out["mean_step_reward"])


def test_cleanrl_script_micro_run(tmp_path):
    save, logs = str(tmp_path / "cleanrl.ckpt"), str(tmp_path / "tb")
    history = ppo_continuous_action.main(
        ["--cpu", "--num_envs", "8", "--num_steps", "4", "--total_steps", "64",
         "--minibatch_size", "32", "--save_path", save, "--log_dir", logs, "--track"])
    assert os.path.exists(save) and len(history) == 2
    (run,) = os.listdir(logs)
    with open(os.path.join(logs, run, "metrics.jsonl")) as f:
        first = json.loads(f.readline())
    assert {"charts/reward_mean", "charts/env_steps_per_s"} <= set(first)


def test_vec_env_wrappers():
    task = port.task_registry.make_task("position_setpoint_task", num_envs=4, seed=2,
                                        device="cpu")
    env = vec_env.ExtractObsWrapper(task)
    obs = env.reset()
    assert isinstance(obs, torch.Tensor) and obs.shape == (4, 13)
    obs, rew, dones, _ = env.step(torch.zeros((4, 4)))
    assert dones.shape == (4,) and dones.dtype == torch.float32
    venv = vec_env.AerialGymVecEnv(task)
    obs, info = venv.reset(seed=5)
    assert isinstance(obs["obs"], np.ndarray) and info == {}
    for actions in (np.zeros((4, 4), np.float32), torch.zeros((4, 4), dtype=torch.float64)):
        obs, rew, term, trunc, _ = venv.step(actions)
        assert obs["obs"].shape == (4, 13) and rew.dtype == np.float32
        assert term.dtype == np.bool_ and trunc.dtype == np.bool_
    assert venv.observation_space["obs"].shape == (13,)
    venv.close()
