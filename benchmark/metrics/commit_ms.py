"""``commit_ms.<kind>``: mean ms a call of the schedule loop's commits (``schedule.commit``, one a step), summed a call,
over the traced calls the profiler did not cover; None where no such
call holds the span (a renamed span reads as missing, not as 0)."""

SPAN = "schedule.commit"


def read(run, name):
    if not any(SPAN in s for s in run.spans):
        return None
    return run.mean_span(name, SPAN)
