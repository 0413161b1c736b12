"""``pack_ms.<kind>``: mean ms a call of the span ``plan.pack`` (observe and pack on the mirror),
over the traced calls the profiler did not cover."""


def read(run, name):
    return run.mean_span(name, "plan.pack")
