"""``torch_ops_device_ms.<kind>``: device ms a call of every kernel not
named ``greedy_kernel`` (the union's torch ops: selection, repair,
validation, the schedule's commit), from the profiler's trace of the
first calls of the window."""


def read(run, name):
    dev = run.device
    if name.split(".", 1)[-1] != run.kind or dev is None or not run.profiled:
        return None
    total = sum(dur for call in dev.per_call.values()
                for kname, dur in call if "greedy_kernel" not in kname)
    return total / 1e3 / run.profiled
