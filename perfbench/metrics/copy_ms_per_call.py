"""Device time of the host-to-device and device-to-host copies per traced
call, in ms."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    return sum(c.copy_us for c in calls) / len(calls) / 1e3 if calls else None
