"""Metric readers: `metrics/<metric>.py` reads the metric of that name.

Each has `read(run)`, where `run` is what harness.run returned: its
"window" (the host clock's readings) and, in a traced run, its "trace"
(trace.TraceStats).  A reader that finds nothing to read returns None, and
the metric is left out of the run's line.
"""
