"""setup_s: from the start of the process to the start of the window on
the host clock: imports, building the program's objects and the seeded
inputs, the native builds (on a checkout's first run), warm-up of the
cell's own shapes."""


def read(ctx):
    return ctx["setup_s"]
