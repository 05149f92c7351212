"""Device time per traced call of every kernel, memset and device-to-device
copy that is not the program's own (PyTorch's), in ms."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    return sum(c.glue_us for c in calls) / len(calls) / 1e3 if calls else None
