"""``host_syncs.<kind>``: blocking device-to-host reads a cut. The
program's ``device_syncs_total`` at the sites a schedule cut reads
(``found``, one a step; ``repair-gate``, one a union solve; ``fetch``,
the matrix), summed, over its ``plan_schedules_total``, the cuts that
returned a schedule. Both count every cut of the process (the warm-up
included; the count a cut does not depend on the profiler). Reads of
the per-tick plan and of executed steps (``lane``, ``prefilter``,
``selection``, ``step-validate``) are left out; a cut that falls back
to a per-tick plan would still add its union's ``repair-gate`` reads,
and the cells' cuts never fall back. None where the program keeps no
such counters."""

CUT_SITES = ("found", "repair-gate", "fetch")


def read(run, name):
    if name.split(".", 1)[-1] != run.kind:
        return None
    from k8s_spot_rescheduler_tpu_torch.metrics import registry

    snapshot = getattr(registry, "host_sync_snapshot", None)
    if snapshot is None:
        return None
    counts = snapshot()
    if not counts["plan_schedules"]:
        return None
    by_site = counts["by_site"]
    return sum(by_site.get(s, 0.0) for s in CUT_SITES) / counts["plan_schedules"]
