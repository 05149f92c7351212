"""The card's compute time per call over the whole window: the device time
of every kernel, memset and device-to-device copy of the window's calls
(the program's and PyTorch's alike), summed and divided by the number of
calls, in ms.  It is what one call costs the card's SMs, and so sets how
many such calls one card serves.  The host copies are left out: a pageable
copy's time is paced by the host staging it, as the host-clock readings
are."""


def read(run):
    calls = run["trace"].calls if run["trace"] else []
    ms = sum(c.kernel_us + c.glue_us for c in calls) / 1e3
    return ms / len(calls) if ms > 0 else None
