"""The number of device operations per traced call that are not the
program's own kernels or its host copies (PyTorch's kernels, memsets and
device-to-device copies)."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    return sum(c.glue_n for c in calls) / len(calls) if calls else None
