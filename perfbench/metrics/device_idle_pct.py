"""The share of the traced calls' time (the union of their spans: the
harness's own work between calls left out) with no kernel and no copy on
the card, in %."""


def read(run):
    t = run["trace"]
    return 100 * (1 - t.busy_us / t.window_us) if t and t.window_us > 0 else None
