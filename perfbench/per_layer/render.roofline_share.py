"""render.roofline_share: the ray cast's least time on the first traced
step's poses and tables (``counts/raycast.py``: f32 operations over
67 TFLOP/s against bytes over 3.35 TB/s) over the device time of every
kernel launched inside that step's render span (%). Whatever implements
the render, the span reads the same work."""


def read(ctx):
    spans = ctx["trace"].spans.get("render")
    if not spans or spans[0]["device_us"] <= 0.0 or "raycast_s" not in ctx["bounds"]:
        return None
    return 100.0 * ctx["bounds"]["raycast_s"] / (spans[0]["device_us"] * 1e-6)
