"""Per traced call: its wall time less the union of its device intervals
(the time the card has nothing of the call to do), the mean, in ms."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    return sum(c.wall_us - c.device_us for c in calls) / len(calls) / 1e3 if calls else None
