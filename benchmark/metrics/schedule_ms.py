"""``schedule_ms.<kind>``: mean ms a call of the span ``plan.solve`` inside ``plan.schedule`` (the 32-step loop and its one fetch),
over the traced calls the profiler did not cover."""


def read(run, name):
    return run.mean_span(name, "plan.solve")
