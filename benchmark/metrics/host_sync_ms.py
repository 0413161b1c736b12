"""``host_sync_ms.<kind>``: mean ms a call of the host blocked on the card at every device-to-host read (``device.sync``, each site), summed a call,
over the traced calls the profiler did not cover; None where no such
call holds the span (a renamed span reads as missing, not as 0)."""

SPAN = "device.sync"


def read(run, name):
    if not any(SPAN in s for s in run.spans):
        return None
    return run.mean_span(name, SPAN)
