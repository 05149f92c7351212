"""The 95th percentile (linear between ranks) of every API call's wall time
in the window, from the call to the bytes it returns, in ms.  Read from the
unprofiled window of a --trace 1 run, as window_MBps is."""
import numpy as np


def read(run):
    lat = run["window"].latencies_s
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
