"""update.host_launches.ppo: the runtime or driver calls that enqueued device
work while the host was inside the port's ``ppo.update`` span
(``rl/ppo.PPOTrainer.update``: the moments, GAE and every optimizer step,
their collectives included), over the number of ``ppo.update`` spans in
rank 0's traced slice (``harness/program_spans.py``)."""

from perfbench.harness.program_spans import totals


def read(ctx):
    t = totals(ctx, "ppo.update")
    return None if t is None else t["launches"] / t["calls"]
