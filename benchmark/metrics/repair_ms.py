"""``repair_ms.<kind>``: mean ms a call of repair where the gate fired (``union.repair``), summed a call,
over the traced calls the profiler did not cover; None where no such
call holds the span (a renamed span reads as missing, not as 0)."""

SPAN = "union.repair"


def read(run, name):
    if not any(SPAN in s for s in run.spans):
        return None
    return run.mean_span(name, SPAN)
