"""allreduce.device_ms.ppo: the device time of the work launched inside the
port's ``ppo.allreduce`` spans (every collective ``rl/ppo.PPOTrainer.update``
makes: the gradients, the advantages' moments, the normalisers' moments, the
metrics; NCCL's kernels, their wait for the slowest rank included), over the
number of ``ppo.update`` spans in rank 0's traced slice (ms;
``harness/program_spans.py``)."""

from perfbench.harness.program_spans import totals


def read(ctx):
    upd, red = totals(ctx, "ppo.update"), totals(ctx, "ppo.allreduce")
    if upd is None or red is None:
        return None
    return red["device_us"] / upd["calls"] * 1e-3
