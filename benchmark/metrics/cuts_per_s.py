"""``cuts_per_s``: cuts completed over the whole window, the churn's
hand-off to the mirror included and its draw (the harness's load
generator) left out."""


def read(run, name):
    if run.kind != "cut" or run.window_s <= 0:
        return None
    return len(run.latency_s) / run.window_s
