"""``mirror_sync_ms.<kind>``: host ms a call to hand its churn to the
simulated API server, whose hooks update the columnar mirror (mean over
the window's calls; the churn's draw is the harness's and is left out)."""


def read(run, name):
    if name.split(".", 1)[-1] != run.kind or not run.sync_s:
        return None
    return 1e3 * sum(run.sync_s) / len(run.sync_s)
