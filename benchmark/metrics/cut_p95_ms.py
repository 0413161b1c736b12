"""``cut_p95_ms``: the 95th percentile of every cut of the window, from
the call of ``plan_schedule`` to its return (linear interpolation)."""

import numpy as np


def read(run, name):
    if run.kind != "cut" or not run.latency_s:
        return None
    return float(np.percentile(run.latency_s, 95)) * 1e3
