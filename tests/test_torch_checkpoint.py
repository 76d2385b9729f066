"""Saved state and resumable training in the port, held against the port
itself: ``utils/checkpoint`` (any state record, its generators, the
``like`` check, atomic writes), ``EnvManager.save_state`` / ``load_state``
and ``PPOTrainer``'s training state.

The bar is bit equality (``torch.equal``): a restored state continues the
trajectory it was saved from with the same draws, and PPO resumed after 2
of 4 iterations ends with the parameters, Adam's state, the normalizer,
the generators and the env carry of the straight 4-iteration run. This
file imports no JAX, so the card tests (``cuda`` marker; they skip without
a GPU) run on the card too:

    python -m pytest tests/test_torch_checkpoint.py -q -m cuda
"""

import dataclasses
import os

import pytest
import torch

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig)
from aerial_gym_simulator_tpu_torch.rl.ppo import PPOConfig, PPOTrainer
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import build_ray_sensor_params
from aerial_gym_simulator_tpu_torch.sim.structs import replace
from aerial_gym_simulator_tpu_torch.utils import checkpoint

N, T = 16, 8                     # PPO: envs x horizon
CAMERA_NAMES = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
                "lee_velocity_control")


@pytest.fixture(autouse=True, scope="module")
def single_torch_thread():
    """These tests run thousands of tiny eager ops; torch's intra-op threads
    buy them nothing and, when several test workers share the cores, their
    spinning costs minutes. One thread while this module runs."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; chip_smoke.py runs this check on the H100")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# utils/checkpoint
# ---------------------------------------------------------------------------


def _position_task(n=4, seed=5, device="cpu"):
    return port.task_registry.make_task("position_setpoint_task", num_envs=n, seed=seed,
                                        device=device)


def _roll(step_fn, carry, actions, steps):
    for _ in range(steps):
        carry, *_ = step_fn(carry, actions)
    return carry


def test_state_replays_with_its_generators(tmp_path):
    """A saved (state, dict) with the state's generator met twice: the
    continuation from the file equals the straight one bit for bit, the
    generator restored once and shared, as it was."""
    task = _position_task()
    step_fn, carry, _ = task.make_step_fn()
    actions = torch.full((4, 4), 0.3)
    carry = _roll(step_fn, carry, actions, 3)
    extra = {"h": torch.arange(6.0).reshape(2, 3), "gen": carry.rng, "tag": "x", "k": 7}
    path = str(tmp_path / "state.pt")
    checkpoint.save_state(path, (carry, extra))

    ahead = _roll(step_fn, carry, actions, 4)
    draws = torch.rand(5, generator=ahead.rng)
    restored, r_extra = checkpoint.load_state(path, like=(ahead, extra))
    assert r_extra["gen"] is restored.rng and restored.rng is not ahead.rng
    assert r_extra["tag"] == "x" and r_extra["k"] == 7
    assert torch.equal(r_extra["h"], extra["h"])
    again = _roll(step_fn, restored, actions, 4)
    for f in dataclasses.fields(again):
        if f.name != "rng":
            assert torch.equal(getattr(again, f.name), getattr(ahead, f.name)), f.name
    assert torch.equal(torch.rand(5, generator=again.rng), draws)
    # without a template: plain dicts of the record's fields
    plain, _ = checkpoint.load_state(path)
    assert set(plain) == {f.name for f in dataclasses.fields(carry)}
    assert torch.equal(plain["pos"], carry.pos)
    task.close()


def test_load_state_like_raises_on_a_mismatch(tmp_path):
    small, large = _position_task(n=4), _position_task(n=8)
    path = str(tmp_path / "small.pt")
    checkpoint.save_state(path, small.state)
    with pytest.raises(ValueError, match="pos"):
        checkpoint.load_state(path, like=large.state)
    with pytest.raises(ValueError, match="structure"):
        checkpoint.load_state(path, like={"pos": small.state.pos})
    # a record that gained a field since the file was written
    old = dataclasses.make_dataclass("Carry", [("a", torch.Tensor)])
    new = dataclasses.make_dataclass("Carry", [("a", torch.Tensor), ("b", torch.Tensor)])
    checkpoint.save_state(path, old(a=torch.zeros(3)))
    with pytest.raises(ValueError, match="fields"):
        checkpoint.load_state(path, like=new(a=torch.zeros(3), b=torch.zeros(3)))
    with pytest.raises(ValueError, match="torch.float32"):
        checkpoint.load_state(path, like=old(a=torch.zeros(3, dtype=torch.int32)))


def test_generator_is_not_restored_on_another_device_type(tmp_path):
    """A CPU generator's state cannot seed a CUDA generator, nor the other
    way round: the load refuses instead of drawing another stream."""
    gen = torch.Generator().manual_seed(3)
    plain = checkpoint.to_plain({"gen": gen})
    plain["gen"]["__generator__"] = "cuda:0"
    path = str(tmp_path / "gen.pt")
    torch.save(plain, path)
    with pytest.raises(ValueError, match="saved on cuda cannot be restored on cpu"):
        checkpoint.load_state(path, like={"gen": torch.Generator()})


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that dies mid-write leaves the previous file as it was and no
    temporary file beside it."""
    path = str(tmp_path / "state.pt")
    checkpoint.save_state(path, {"x": torch.ones(4)})

    def dies(obj, f):
        f.write(b"half a checkpoint")
        raise OSError("disk gone")

    monkeypatch.setattr(torch, "save", dies)
    with pytest.raises(OSError, match="disk gone"):
        checkpoint.save_state(path, {"x": torch.zeros(4)})
    monkeypatch.undo()
    assert os.listdir(tmp_path) == ["state.pt"]
    assert torch.equal(checkpoint.load_state(path)["x"], torch.ones(4))


# ---------------------------------------------------------------------------
# EnvManager.save_state / load_state
# ---------------------------------------------------------------------------


def _noisy_camera_env(n, device):
    env = port.SimBuilder().build_env(*CAMERA_NAMES, device=device, num_envs=n, seed=1)
    cam = build_ray_sensor_params(BaseDepthCameraConfig(height=12, width=16), device)
    env.params = replace(env.params, camera=replace(cam, enable_noise=True))
    return env


def _replay(env, path, actions, steps=3):
    """save_state, ``steps`` steps with render(), load_state, the same steps
    again -> (poses, frames) of both runs."""
    env.save_state(path)
    runs = []
    for i in range(2):
        if i:
            env.load_state(path)
            assert env._sensor_frames is None and env._sensor_seg is None
        poses, frames = [], []
        for _ in range(steps):
            env.step(actions)
            env.render()
            poses.append(env.state.pos.clone())
            frames.append((env.get_obs()["depth_range_pixels"].clone(),
                           env.get_obs()["segmentation_pixels"].clone()))
        runs.append((poses, frames, env.step_counter))
    return runs


def test_env_manager_replays_poses_and_noisy_frames(tmp_path):
    """The obstacle env with a noisy segmentation camera at 2 envs: after
    load_state the next steps and renders equal the first ones bit for bit
    (the noise draws from the state's generator, which the file holds)."""
    env = _noisy_camera_env(2, "cpu")
    env.params = replace(env.params, env=replace(env.params.env, substep_std=1.0))
    actions = torch.full((2, 4), 0.1)
    for _ in range(5):
        env.step(actions)
    (p1, f1, c1), (p2, f2, c2) = _replay(env, str(tmp_path / "sim.pt"), actions)
    assert c1 == c2 == 8
    for a, b in zip(p1, p2):
        assert torch.equal(a, b)
    for (d1, s1), (d2, s2) in zip(f1, f2):
        assert torch.equal(d1, d2) and torch.equal(s1, s2)
    assert not torch.equal(f1[0][0], f1[1][0])          # the frames did move


# ---------------------------------------------------------------------------
# PPO: resumable training state
# ---------------------------------------------------------------------------


def _trainer(rnn=None, seed=3):
    task = _position_task(n=N, seed=seed)
    cfg = PPOConfig(num_envs=N, horizon=T, minibatch_size=N * T // 2, epochs=2, seed=seed,
                    rnn=rnn, rnn_hidden=16)
    return PPOTrainer(task, cfg)


def _snapshot(trainer):
    """Everything that evolves in training, as comparable tensors."""
    carry = trainer.env_carry
    task_carry = carry[0] if trainer.cfg.rnn else carry
    out = {f"param.{k}": v for k, v in trainer.network.state_dict().items()}
    for i, p in enumerate(trainer.network.parameters()):
        for k, v in trainer.optimizer.state[p].items():
            out[f"adam.{i}.{k}"] = v
    out.update({f"norm.{k}": v for k, v in trainer.norm.items()})
    out.update(lr=trainer.lr, obs=trainer.obs, pos=task_carry.pos, linvel=task_carry.linvel,
               generator=trainer.generator.get_state(), sim_rng=task_carry.rng.get_state(),
               iter=torch.tensor(trainer._iter))
    if trainer.cfg.rnn:
        out.update(hidden=carry[1], done_prev=carry[2])
    return out


@pytest.mark.parametrize("rnn", [None, "gru"])
def test_ppo_resume_is_bit_exact(tmp_path, rnn):
    """2 iterations, saved, the trainer thrown away; a fresh trainer resumed
    to 4 == a straight 4-iteration run, bit for bit (position task, 16
    envs x horizon 8, MLP and GRU)."""
    ckpt = str(tmp_path / "ckpt")
    steps = N * T
    straight = _trainer(rnn)
    straight.train(total_env_steps=4 * steps)

    victim = _trainer(rnn)
    victim.train(total_env_steps=2 * steps, ckpt_dir=ckpt, save_every=2)
    assert sorted(os.listdir(ckpt)) == ["iter_2.pt"]
    del victim

    resumed = _trainer(rnn)
    history = resumed.train(total_env_steps=4 * steps, log_every=1, ckpt_dir=ckpt,
                            save_every=4, resume=True)
    assert [m["iter"] for m in history] == [2, 3]
    assert sorted(os.listdir(ckpt)) == ["iter_2.pt", "iter_4.pt"]
    want, got = _snapshot(straight), _snapshot(resumed)
    assert set(want) == set(got)
    for k in want:
        assert torch.equal(want[k], got[k]), k
    # the task holds the resumed carry, as after any train()
    assert resumed.task.state is (resumed.env_carry[0] if rnn else resumed.env_carry)


def test_training_state_keeps_the_newest_two(tmp_path, caplog):
    trainer = _trainer()
    ckpt = str(tmp_path / "ckpt")
    assert trainer.restore_training_state(ckpt) == 0
    assert "no training state" in caplog.text
    trainer.train(total_env_steps=3 * N * T, ckpt_dir=ckpt, save_every=1)
    assert sorted(os.listdir(ckpt)) == ["iter_2.pt", "iter_3.pt"]
    # a trainer of another layout is refused
    other = _trainer(rnn="gru")
    with pytest.raises(ValueError, match="structure|fields|template"):
        other.restore_training_state(ckpt)


# ---------------------------------------------------------------------------
# the card (chip_smoke.py's plumbing phase runs the same at full width)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_state_moves_between_cpu_and_card(tmp_path, cuda_device):
    """A CPU file loads onto the card (the template's device) and a card
    file back onto the CPU, values unchanged; generators keep their device
    type."""
    cpu = {"x": torch.randn(5, 3), "n": torch.arange(4, dtype=torch.int32)}
    path = str(tmp_path / "cpu.pt")
    checkpoint.save_state(path, cpu)
    on_card = checkpoint.load_state(path, like={k: v.to(cuda_device) for k, v in cpu.items()})
    assert all(v.is_cuda and torch.equal(v.cpu(), cpu[k]) for k, v in on_card.items())
    checkpoint.save_state(path, on_card)
    back = checkpoint.load_state(path, like=cpu)
    assert all(torch.equal(v, cpu[k]) for k, v in back.items())
    checkpoint.save_state(path, {"gen": torch.Generator().manual_seed(1)})
    with pytest.raises(ValueError, match="cannot be restored"):
        checkpoint.load_state(path, like={"gen": torch.Generator(device=cuda_device)})


@pytest.mark.cuda
def test_env_manager_replays_on_card(tmp_path, cuda_device):
    """Saved sim state on the card: poses and noisy frames bit-equal after
    load_state, the segmentation render (K2) launched on every render."""
    from aerial_gym_simulator_tpu_torch.ops import raycast_cuda as rc
    env = _noisy_camera_env(64, cuda_device)
    actions = torch.full((64, 4), 0.1, device=cuda_device)
    for _ in range(5):
        env.step(actions)
    rc.LAUNCHES["raycast_seg"] = 0
    (p1, f1, _), (p2, f2, _) = _replay(env, str(tmp_path / "sim.pt"), actions)
    assert rc.LAUNCHES["raycast_seg"] == 6
    assert all(torch.equal(a, b) for a, b in zip(p1, p2))
    assert all(torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(f1, f2))


@pytest.mark.cuda
def test_ppo_resume_is_bit_exact_on_card(tmp_path, cuda_device):
    def trainer():
        task = _position_task(n=N, seed=3, device=None)
        return PPOTrainer(task, PPOConfig(num_envs=N, horizon=T, minibatch_size=N * T // 2,
                                          epochs=2, seed=3))
    ckpt = str(tmp_path / "ckpt")
    straight = trainer()
    straight.train(total_env_steps=4 * N * T)
    trainer().train(total_env_steps=2 * N * T, ckpt_dir=ckpt, save_every=2)
    resumed = trainer()
    resumed.train(total_env_steps=4 * N * T, ckpt_dir=ckpt, save_every=4, resume=True)
    want, got = _snapshot(straight), _snapshot(resumed)
    for k in want:
        assert torch.equal(want[k], got[k]), k
