"""``device_idle.<kind>``: the share of the traced window, in percent,
in which no kernel, copy or set ran on the card (from the profiler's
trace of the first calls of the window; the churn's hand-off to the
mirror included, its draw left out)."""


def read(run, name):
    dev = run.device
    if name.split(".", 1)[-1] != run.kind or dev is None or dev.window_s <= 0:
        return None
    return 100.0 * (1.0 - dev.busy_s / dev.window_s)
