"""The capability examples on the port.

Each module here is a counterpart of a script in the repository's
``examples/`` (which drives the JAX package) and runs as

    python -m aerial_gym_simulator_tpu_torch.examples.<name> [flags] [--cpu]

with that script's flags and defaults. Like every entry point of the port
it runs on CUDA unless given ``--cpu`` (or ``device="cpu"`` in process).

  * ``sys_id``: the motor step response (Euler and RK4) and the fit of the
    asymmetric motor time constants from a measured trace;
  * ``imu_data_collection``: the IMU stream of a hovering quad, as CSV;
  * ``bem_standalone``: the NeuroBEM blade-element-momentum rotor model;
  * ``differentiable_sysid_example``: motor time constant and drag
    recovered by gradient descent through the simulator;
  * ``trajectory_optimization_example``: a motor-thrust sequence optimized
    through the simulator;
  * ``tune_controllers``: step-response metrics of the Lee controllers, and
    position / velocity gains tuned by gradient (``--grad``).
"""
