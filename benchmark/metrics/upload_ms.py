"""``upload_ms.<kind>``: mean ms a call of the spans ``plan.delta-upload`` (the resident cache's delta or full upload), summed a call,
over the traced calls the profiler did not cover."""


def read(run, name):
    return run.mean_span(name, "plan.delta-upload")
