"""The least time of the traced calls' required work (metrics/_h100.py,
counted from the cell's shapes) over the device time of every kernel of
those calls, the program's and PyTorch's alike, in %.  It reads the same
work whatever implements it, so it cannot pass 100 % when work moves
between glue and a kernel."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    device_ms = sum(c.kernel_us + c.glue_us for c in calls) / 1e3
    return 100 * sum(c.least_ms for c in calls) / device_ms if device_ms > 0 else None
