"""Traffic generators: one module per kind of request stream.

A traffic mix is a data file `<mix>.json` here whose "generator" names one
of these modules.  Each module has a `Traffic(config, mix, seed)` class:

* `call(i, last)`: the i-th call of the run (warm-up calls first, then the
  window's), given the previous call's output `last`;
* `cold_call(j)`: a call under a key set that no other call uses;
* `check(call, out, device)`: (answers checked, answers wrong) of a call's
  output against the plain reference.

Every input comes from `seed`; a call's payload comes from a pool made
once, so that calls cost the caller next to nothing.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Call:
    entry: str                # the API function's name
    args: tuple               # its positional arguments
    payload: int              # payload bytes that the call protects
    work: dict                # the work it needs (metrics/_h100.least_ms)
    expect: dict = field(default_factory=dict)  # what check() needs
