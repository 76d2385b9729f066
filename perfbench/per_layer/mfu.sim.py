"""mfu.sim: the step's counted work at the card's peaks over the measured
step time (%). The counted work is the ray cast's least time on the step's
poses and tables, plus, where the step runs them, the ViT encoder's and the
policy's products at the bf16 peak (the kind's ``bounds()``). The step time
is the mean gap between the ends of the window's steps outside the traced
slice, on CUDA events."""


def read(ctx):
    if ctx["step_s"] <= 0.0 or not ctx["trace"].device or "counted_s" not in ctx["bounds"]:
        return None
    return 100.0 * ctx["bounds"]["counted_s"] / ctx["step_s"]
