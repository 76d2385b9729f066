"""Port parity for the whole slice: SimBuilder -> EnvManager.step ->
EnvManager.render (depth + segmentation) on the obstacle env with the
camera quad, against the JAX package from a state carried across; and the
port's independence from JAX.

Tolerances: robot state atol 1e-4 after 3 env steps (30 substeps, see
test_torch_dynamics.py); depth pixels atol 2e-3 (normalized by max_range,
so 2 cm) and seg agreement > 0.999 on hit pixels (test_torch_raycast.py).
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import aerial_gym_simulator_tpu  # noqa: F401  (registers the JAX configs)
from aerial_gym_simulator_tpu.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig as JCameraConfig)
from aerial_gym_simulator_tpu.sensors.raycast_sensor import (
    build_ray_sensor_params as j_build_camera)
from aerial_gym_simulator_tpu.sim.sim_builder import SimBuilder as JSimBuilder

import aerial_gym_simulator_tpu_torch as port
from aerial_gym_simulator_tpu_torch.config.sensor_config.sensor_configs import (
    BaseDepthCameraConfig as TCameraConfig)
from aerial_gym_simulator_tpu_torch.sensors.raycast_sensor import (
    build_ray_sensor_params as t_build_camera)
from aerial_gym_simulator_tpu_torch.sim.convert import record_to_numpy, state_from_numpy
from aerial_gym_simulator_tpu_torch.sim.structs import replace

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "aerial_gym_simulator_tpu_torch"
N = 4
NAMES = ("base_sim", "env_with_obstacles", "base_quadrotor_with_camera",
         "lee_velocity_control")
CAM = dict(height=24, width=32)


def _leaves_match(port_rec, ref_rec, path=""):
    if isinstance(ref_rec, dict):
        for k, v in ref_rec.items():
            _leaves_match(port_rec[k], v, f"{path}.{k}")
    elif ref_rec is None or isinstance(ref_rec, (bool, str)):
        assert port_rec == ref_rec, path
    else:
        np.testing.assert_allclose(np.asarray(port_rec, np.float64),
                                   np.asarray(ref_rec, np.float64), atol=1e-6, err_msg=path)


@pytest.fixture(scope="module")
def envs():
    jenv = JSimBuilder().build_env(*NAMES, num_envs=N, seed=2)
    jenv.params = jenv.params.replace(camera=j_build_camera(JCameraConfig(**CAM)))
    tenv = port.SimBuilder().build_env(*NAMES, device="cpu", num_envs=N, seed=2)
    tenv.params = replace(tenv.params, camera=t_build_camera(TCameraConfig(**CAM), "cpu"))
    tenv.state = state_from_numpy(record_to_numpy(jenv.state), "cpu", seed=2)
    return jenv, tenv


def test_builders_agree(envs):
    jenv, tenv = envs
    _leaves_match(record_to_numpy(tenv.params), record_to_numpy(jenv.params))


def test_step_and_render_match_jax(envs):
    jenv, tenv = envs
    rs = np.random.RandomState(1)
    for _ in range(3):
        a = rs.uniform(-0.5, 0.5, (N, 4)).astype(np.float32)
        jenv.step(a)
        tenv.step(torch.from_numpy(a))
    for f in ("pos", "quat", "linvel"):
        np.testing.assert_allclose(getattr(tenv.state, f).numpy(),
                                   np.asarray(getattr(jenv.state, f)), atol=1e-4, err_msg=f)
    jenv.render()
    tenv.render()
    j_obs, t_obs = jenv.get_obs(), tenv.get_obs()
    depth_j = np.asarray(j_obs["depth_range_pixels"])
    depth_t = t_obs["depth_range_pixels"].numpy()
    assert depth_t.shape == (N, CAM["height"], CAM["width"])
    np.testing.assert_allclose(depth_t, depth_j, atol=2e-3, rtol=0)
    seg_j = np.asarray(j_obs["segmentation_pixels"])
    seg_t = t_obs["segmentation_pixels"].numpy()
    hit = seg_j != -2
    assert hit.any()
    assert (seg_t[hit] == seg_j[hit]).mean() > 0.999
    for k in ("robot_euler_angles", "robot_body_linvel", "robot_body_angvel"):
        np.testing.assert_allclose(t_obs[k].numpy(), np.asarray(j_obs[k]), atol=1e-3,
                                   err_msg=k)
    assert set(j_obs) <= set(t_obs) | {"lidar_range_pixels", "rgb_pixels"}


def test_post_reward_resets_only_done_envs(envs):
    _, tenv = envs
    before = tenv.state.pos.clone()
    crashes = torch.tensor([1.0, 0.0, 0.0, 0.0])
    tenv.post_reward_calculation_step(crashes=crashes, truncations=torch.zeros(N))
    assert torch.equal(tenv.state.pos[1:], before[1:])
    assert int(tenv.state.sim_steps[0]) == 0


def test_build_env_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.SimBuilder().build_env(*NAMES, num_envs=2)


def _sources():
    return sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"]


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "flax", "optax", "aerial_gym_simulator_tpu")


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_source_imports_no_jax(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


def test_scan_covers_the_capture_slice():
    """The scan above reads every module the normal/face-id, RGB and lidar
    captures run, and the kernel source those modules build."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in ("ops/raycast.py", "ops/raycast_cuda.py", "sensors/raycast_sensor.py",
                   "config/sensor_config/sensor_configs.py", "config/robot_config/catalog.py",
                   "sim/env_manager.py", "sim/params.py", "sim/dynamics.py", "sim/convert.py",
                   "sim/structs.py"):
        assert module in scanned, module
    assert (PKG / "csrc" / "raycast.cu").exists()


NAVIGATION_RL_MODULES = ("tasks/lidar_navigation_task.py", "tasks/navigation_task.py",
                         "tasks/__init__.py", "rl/ppo.py", "rl/networks.py",
                         "sim2real/policy.py", "control/controllers.py",
                         "config/__init__.py", "config/env_config/obstacle_envs.py",
                         "config/asset_config/env_object_config.py",
                         "config/controller_config/lee_controller_config.py")


def test_scan_covers_the_navigation_rl_slice():
    """The scan reads every module of navigation RL: the LiDAR/radar tasks,
    the recurrent learner and policy archives, the acceleration controller
    and the lidar-nav scene."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in NAVIGATION_RL_MODULES + ("sensors/raycast_sensor.py", "sim/convert.py",
                                           "config/sensor_config/sensor_configs.py",
                                           "config/robot_config/catalog.py"):
        assert module in scanned, module


POSITION_VARIANT_MODULES = ("tasks/position_setpoint_variants.py",
                            "utils/collision_image_generator.py", "models/train_vae.py",
                            "config/sim_config/base_sim_config.py",
                            "config/env_config/base_env_config.py",
                            "registry/registries.py", "sim/sim_builder.py")


def test_scan_covers_the_position_variant_slice():
    """The scan reads every module of the position-task variants, the new
    controllers and robots, and the collision-label render."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in POSITION_VARIANT_MODULES + ("control/controllers.py", "sim/dynamics.py",
                                              "config/robot_config/catalog.py",
                                              "config/__init__.py", "utils/math.py"):
        assert module in scanned, module


PLUMBING_MODULES = ("utils/metrics.py", "utils/checkpoint.py", "utils/curriculum_manager.py",
                    "tasks/custom_task.py", "rl_training/__init__.py", "rl_training/vec_env.py",
                    "rl_training/rl_games/runner.py",
                    "rl_training/cleanrl/ppo_continuous_action.py",
                    "rl_training/sample_factory/aerialgym_env.py",
                    "models/torch_vae_import.py")


def test_scan_covers_the_training_plumbing_slice():
    """The scan reads every module of the training plumbing: the metrics
    writer, saved state, the curriculum manager, the custom task, the
    adapters and the reference-VAE importer, with the learner and the env
    manager that use them; the YAML configs ship beside the runner."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in PLUMBING_MODULES + ("rl/ppo.py", "sim/env_manager.py",
                                      "tasks/navigation_task.py"):
        assert module in scanned, module
    for name in ("ppo_aerial_quad.yaml", "ppo_aerial_quad_navigation.yaml"):
        assert (PKG / "rl_training" / "rl_games" / name).exists(), name


ARTICULATED_MODULES = ("sim/articulated.py", "assets/articulation.py", "sensors/imu.py",
                       "config/robot_config/reconfigurable_urdf.py")


def test_scan_covers_the_articulated_slice():
    """The scan reads every module of the articulated robots, the IMU and
    the sensor catalog, with the modules they changed."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in ARTICULATED_MODULES + ("sim/dynamics.py", "sim/params.py", "sim/structs.py",
                                         "sim/convert.py", "sim/env_manager.py",
                                         "config/robot_config/base_quad_config.py",
                                         "config/robot_config/catalog.py",
                                         "config/sensor_config/sensor_configs.py",
                                         "tasks/position_setpoint_variants.py"):
        assert module in scanned, module


SCENE_MODULES = ("assets/mesh.py", "assets/native_loader.py", "assets/urdf.py",
                 "assets/procedural.py", "envs/scene.py", "ops/_build.py")


def test_scan_covers_the_scenes_slice():
    """The scan reads every module of the forest and dynamic scenes, stereo
    and multi-sensor capture, the mesh assets and the native compiler, with
    the modules they changed; the compiler's C++ source ships in csrc/."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in SCENE_MODULES + ("sensors/raycast_sensor.py", "sim/env_manager.py",
                                   "sim/params.py", "sim/dynamics.py", "sim/convert.py",
                                   "config/asset_config/env_object_config.py",
                                   "config/env_config/obstacle_envs.py", "config/__init__.py",
                                   "config/sensor_config/sensor_configs.py",
                                   "config/robot_config/catalog.py"):
        assert module in scanned, module
    assert (PKG / "csrc" / "scene_compiler.cpp").exists()


DIFFERENTIABLE_MODULES = ("ops/raycast_diff.py", "rl/bptt.py", "rl/population.py")


def test_scan_covers_the_differentiable_slice():
    """The scan reads every module of differentiable training: the ray
    cast's gradient, BPTT and the population, with the modules they use."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in DIFFERENTIABLE_MODULES + ("ops/raycast.py", "ops/raycast_cuda.py",
                                            "rl/ppo.py", "rl/networks.py", "sim/convert.py",
                                            "utils/math.py"):
        assert module in scanned, module


PARALLEL_MODULES = ("parallel/mesh.py", "parallel/distributed.py", "parallel/multiproc.py",
                    "parallel/scaling.py", "parallel/dryrun.py", "utils/env_rng.py")


def test_scan_covers_the_parallel_slice():
    """The scan reads every module of multi-process training: the mesh, the
    sharding of the trainers, the cluster and scaling harnesses, the dry
    run and the draw rule, with the trainers and the ViT they shard."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in PARALLEL_MODULES + ("rl/ppo.py", "rl/bptt.py", "rl/population.py",
                                      "models/vit.py"):
        assert module in scanned, module


DEPLOYMENT_MODULES = ("sim2real/__init__.py", "sim2real/config.py", "sim2real/numpy_policy.py",
                      "sim2real/torch_import.py", "sim2real/torch_export.py",
                      "sim2real/nn_inference_class.py", "sim2real/sample_factory_inference.py",
                      "sim2real/ros_loopback.py", "sim2real/ros_node.py",
                      "viewer/__init__.py", "viewer/offline_viewer.py", "viewer/live_viewer.py",
                      "viewer/web_viewer.py")


def test_scan_covers_the_deployment_slice():
    """The scan reads every module of deployment and the viewers: export,
    import, TorchScript, the inference classes, the ROS node and its
    loopback, the offline, live and web viewers."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in DEPLOYMENT_MODULES + ("sim2real/policy.py", "ops/raycast_cuda.py"):
        assert module in scanned, module


TOOLS_MODULES = ("utils/profiling.py", "utils/debug.py", "utils/helpers.py", "utils/tensor_pid.py",
                 "utils/calculate_mixing_matrix.py", "utils/real_robot_sysid.py",
                 "utils/imu_to_rosbag.py", "robots/__init__.py", "examples/__init__.py",
                 "examples/sys_id.py", "examples/imu_data_collection.py",
                 "examples/bem_standalone.py", "examples/differentiable_sysid_example.py",
                 "examples/trajectory_optimization_example.py", "examples/tune_controllers.py")


def test_scan_covers_the_tools_slice():
    """The scan reads every module of the utilities and the capability
    examples, with the math module they extended."""
    scanned = {str(p.relative_to(PKG)) for p in _sources() if PKG in p.parents}
    for module in TOOLS_MODULES + ("utils/math.py", "utils/device.py"):
        assert module in scanned, module


# (module, argv without --cpu) of every command line the tools slice adds
TOOL_COMMANDS = [
    ("utils.profiling", ["--num_envs", "2", "--iters", "1"]),
    ("examples.sys_id", ["--steps", "2"]),
    ("examples.imu_data_collection", ["--steps", "2"]),
    ("examples.bem_standalone", []),
    ("examples.differentiable_sysid_example", ["--steps", "2", "--iters", "1"]),
    ("examples.trajectory_optimization_example", ["--steps", "2", "--iters", "1"]),
    ("examples.tune_controllers", ["--steps", "2", "--num_envs", "2"]),
]


@pytest.mark.parametrize("module,argv", TOOL_COMMANDS, ids=[m for m, _ in TOOL_COMMANDS])
def test_tool_command_line_needs_cuda_unless_cpu(module, argv):
    """Each new command line runs on CUDA by default and raises without a
    GPU; it never falls back to the CPU on its own."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    import importlib

    mod = importlib.import_module(f"aerial_gym_simulator_tpu_torch.{module}")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.main(argv)


def test_tools_import_no_ros():
    """rospy, rosbag and the ROS messages are imported inside the tools'
    functions only."""
    code = ("import sys\n"
            "import aerial_gym_simulator_tpu_torch.utils.real_robot_sysid\n"
            "import aerial_gym_simulator_tpu_torch.utils.imu_to_rosbag\n"
            "import aerial_gym_simulator_tpu_torch.examples.imu_data_collection\n"
            "ros = ('rospy', 'rosbag', 'mavros_msgs', 'sensor_msgs')\n"
            "sys.exit(1 if any(m in sys.modules for m in ros) else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("function", ["TensorPID.update", "TensorPID.reset_idx",
                                      "_solve_induced_velocity"])
def test_pid_and_bisection_read_nothing_back(function):
    """TensorPID's update and masked reset, and the BEM bisection, stay on
    the device: no .item(), .tolist(), nonzero, .cpu(), .numpy() or host
    conversion."""
    path = PKG / ("utils/tensor_pid.py" if "PID" in function else "examples/bem_standalone.py")
    scope = ast.parse(path.read_text())
    for name in function.split("."):
        scope = next(n for n in ast.iter_child_nodes(scope)
                     if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and n.name == name)
    for node in ast.walk(scope):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("item", "tolist", "nonzero", "cpu", "numpy"), \
                (function, node.attr, node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in ("float", "int", "bool"), (function, node.lineno)


def test_viewers_import_no_matplotlib():
    """matplotlib is imported only by LiveViewer.run (the card's machine
    needs none to render frames)."""
    code = ("import sys\n"
            "import aerial_gym_simulator_tpu_torch.viewer\n"
            "import aerial_gym_simulator_tpu_torch.sim2real.ros_node\n"
            "sys.exit(1 if 'matplotlib' in sys.modules or 'rospy' in sys.modules else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scene_compiler_is_built_lazily():
    """Importing the loader builds nothing: the host compiler runs at the
    first compile call (the tests here import every module)."""
    code = (
        "import sys\n"
        "from aerial_gym_simulator_tpu_torch.assets import native_loader as nl\n"
        "from aerial_gym_simulator_tpu_torch.envs import scene\n"
        "sys.exit(0 if nl._lib is None and nl.LIBRARY._lib is None else 1)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["sim/articulated.py", "sensors/imu.py", "sim/dynamics.py"])
def test_solver_and_imu_read_nothing_back(module):
    """No host read-back on the step: no .item(), .tolist(), nonzero, .cpu()
    or .numpy(), and no torch.linalg.cholesky (it checks its info on the
    host; the solver takes cholesky_ex)."""
    tree = ast.parse((PKG / module).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("item", "tolist", "nonzero", "cpu", "numpy", "cholesky"), \
                (module, node.attr, node.lineno)


@pytest.mark.parametrize("function", ["BPTTTrainer.window", "BPTTTrainer.update",
                                      "remat_step", "clip_by_global_norm_", "detach_carry"])
def test_bptt_update_reads_nothing_back(function):
    """The BPTT window and update read nothing back to the host (the EMA and
    the best parameters move on the device); train() reads at its log
    points only."""
    tree = ast.parse((PKG / "rl/bptt.py").read_text())
    scope = tree
    for name in function.split("."):
        scope = next(n for n in ast.iter_child_nodes(scope)
                     if isinstance(n, (ast.ClassDef, ast.FunctionDef)) and n.name == name)
    for node in ast.walk(scope):
        if isinstance(node, ast.Attribute):
            assert node.attr not in ("item", "tolist", "nonzero", "cpu", "numpy"), \
                (function, node.attr, node.lineno)
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
            assert node.func.id not in ("float", "int", "bool"), (function, node.lineno)


def _module_name(path: str) -> str:
    return path[:-3].replace("/", ".").replace(".__init__", "")


def test_importing_every_module_loads_no_jax():
    wanted = ("tasks.lidar_navigation_task", "rl.ppo", "rl.networks", "sim2real.policy") + tuple(
        _module_name(m) for m in PLUMBING_MODULES + ARTICULATED_MODULES + SCENE_MODULES
        + DIFFERENTIABLE_MODULES + PARALLEL_MODULES + DEPLOYMENT_MODULES + TOOLS_MODULES)
    code = (
        "import importlib, pkgutil, sys\n"
        "import aerial_gym_simulator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'optax', 'aerial_gym_simulator_tpu'))\n"
        f"missing = [m for m in {wanted!r} if p.__name__ + '.' + m not in sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_yaml_runner_imports_without_pyyaml():
    """PyYAML is not on the card's machine: the adapters import without it,
    and only reading a YAML file asks for it."""
    code = (
        "import sys\n"
        "sys.modules['yaml'] = None\n"
        "import aerial_gym_simulator_tpu_torch.rl_training as rt\n"
        "from aerial_gym_simulator_tpu_torch.rl_training.rl_games import runner\n"
        "from aerial_gym_simulator_tpu_torch.rl_training.sample_factory import aerialgym_env\n"
        "from aerial_gym_simulator_tpu_torch.rl_training.cleanrl import ppo_continuous_action\n"
        "try:\n"
        "    runner.load_yaml_config(runner.CONFIG_DIR + '/ppo_aerial_quad.yaml')\n"
        "except ImportError:\n"
        "    sys.exit(0)\n"
        "sys.exit(1)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=str(REPO), env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
