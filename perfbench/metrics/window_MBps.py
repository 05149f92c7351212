"""Payload bytes of the window's completed calls over its wall time, in
MB/s (10^6 bytes): plaintext sealed or opened, sector bytes written or read.
Read from the unprofiled window of a --trace 1 run: on a host whose speed
drifts run to run it spreads too widely to hold a bound end to end."""


def read(run):
    w = run["window"]
    return w.payload_bytes / w.wall_s / 1e6 if w.latencies_s and w.wall_s > 0 else None
