"""Seconds from the start of the process until the window opens: imports,
the kernel library's load (and build, in a checkout's first run), the
inputs, the warm-up and the cold calls."""


def read(run):
    return run["window"].setup_s
