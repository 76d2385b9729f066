"""env_steps_per_s: the env-steps the window's steps completed (envs x
steps, counted by the kind as ``env_steps``) over the window's length on the
host clock, with one synchronisation at each end and none inside."""


def read(ctx):
    steps = ctx["work"].get("env_steps")
    if not steps or ctx["window_s"] <= 0.0:
        return None
    return steps / ctx["window_s"]
