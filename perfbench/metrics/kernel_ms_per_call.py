"""Device time per traced call of the program's own kernels (matched by the
`__global__` names of its CUDA sources), in ms."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    return sum(c.kernel_us for c in calls) / len(calls) / 1e3 if calls else None
