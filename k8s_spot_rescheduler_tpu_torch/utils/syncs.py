"""Blocking device-to-host reads on the plan paths, counted and timed.

Every such read goes through ``device_sync(site, read, value)``: it
counts the read in ``device_syncs_total{site}`` always, and while a
trace is active times it as a ``device.sync`` span with a ``site``
attribute, so a trace says how long the host waited on the card at each
site and the counter says how often.

Sites: ``found`` (a schedule step's one read: the chosen lane and
whether one was found), ``repair-gate`` (a union's repair gate),
``fetch`` (a schedule's matrix), ``lane``, ``prefilter`` and
``selection`` (a per-tick plan's reads), ``step-validate`` (an executed
schedule step's re-proof).
"""

from __future__ import annotations

from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.utils import tracing


def device_sync(site: str, read, value):
    """``read(value)``, a read that blocks the host on the device (``bool``
    of a device flag, ``torch.Tensor.cpu`` of a result), counted in
    ``device_syncs_total{site}`` and, while a trace is active, timed as
    a ``device.sync`` span with a ``site`` attribute."""
    metrics.update_device_sync(site)
    if tracing.current_trace() is None:
        return read(value)
    with tracing.span("device.sync", site=site):
        return read(value)
