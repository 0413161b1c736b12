"""Node-drain actuation state machine.

Host-side reimplementation of the reference's ``scaler`` package
(reference scaler/scaler.go:41-146):

1. taint the node ToBeDeleted so the scheduler won't re-place evicted pods
   onto it mid-drain (scaler.go:77 ``MarkToBeDeleted``);
2. evict every pod, retrying each failed eviction every
   ``eviction_retry_time`` until ``pod_eviction_timeout`` expires
   (scaler.go:47-62). The reference fans out one goroutine per pod and
   fans in over a channel (scaler.go:93-113); here each retry round
   fans the not-yet-evicted set out over a bounded thread pool — one
   slow apiserver call costs one pod-latency per round, not one per
   pod — and emits the reference's per-pod Normal event before the
   first attempt (scaler.go:44);
3. poll every 5 s until every pod is confirmed off the node or the
   timeout passes (scaler.go:119-144);
4. on success un-taint — the drained node stays schedulable as spare
   capacity for the next drain (scaler.go:138-141, README.md:117);
   on any failure un-taint and emit a warning event (the reference's
   deferred cleanup, scaler.go:83-88).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

from k8s_spot_rescheduler_tpu_torch.io.cluster import ClusterClient, EventSink
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.cluster import (
    NodeSpec,
    PodSpec,
    Taint,
    TO_BE_DELETED_TAINT,
    rescheduler_taint_value,
)
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing

VERIFY_POLL_INTERVAL = 5.0  # scaler.go:143 time.Sleep(5 * time.Second)

# The reference spawns one goroutine per pod (scaler.go:93-98); Python
# threads are heavier, so the fan-out is bounded. Workers only call the
# (thread-safe) eviction endpoint and bump a (thread-safe) counter —
# events and retry bookkeeping stay on the actuator thread.
EVICTION_POOL_SIZE = 32


def _evict_round(
    client: ClusterClient,
    pods: Sequence[PodSpec],
    max_graceful_termination: int,
) -> Tuple[List[PodSpec], Optional[Exception]]:
    """One parallel eviction pass; returns (failed pods, last error)."""

    def attempt(pod: PodSpec) -> Optional[Exception]:
        try:
            client.evict_pod(pod, max_graceful_termination)
            metrics.update_evictions_count()
            return None
        except Exception as err:  # noqa: BLE001 — retried until deadline
            return err

    if len(pods) == 1:  # no pool for the common one-pod round
        errs = [attempt(pods[0])]
    else:
        with ThreadPoolExecutor(
            max_workers=min(len(pods), EVICTION_POOL_SIZE)
        ) as pool:
            errs = list(pool.map(attempt, pods))
    failed = [pod for pod, err in zip(pods, errs) if err is not None]
    last_error = next(
        (err for err in reversed(errs) if err is not None), None
    )
    return failed, last_error


class DrainError(Exception):
    pass


def drain_node(
    client: ClusterClient,
    recorder: EventSink,
    node: NodeSpec,
    pods: Sequence[PodSpec],
    *,
    clock: Clock,
    max_graceful_termination: int,
    pod_eviction_timeout: float,
    eviction_retry_time: float,
    identity: str = "",
    schedule_step: int = -1,
) -> None:
    """Drain ``node`` of ``pods``; raises DrainError on failure
    (reference scaler.go:68-146 ``DrainNode``).

    ``schedule_step`` >= 0 marks a drain executed from a device-cut
    drain schedule (planner/schedule.py): the step index rides the
    node's Normal event and the eviction trace spans, so a postmortem
    can tell schedule-executed drains from per-tick plans. The cadence
    is unchanged either way — the schedule changes how drains are
    DECIDED (one fetch per horizon), never how they are verified.

    The taint is stamped with an ownership value (``identity`` — the
    replica's stable holder id — plus a wall timestamp): the cluster
    autoscaler applies the SAME taint key during its own scale-downs, so
    the controller's orphaned-taint sweep only ever removes taints
    carrying this marker (models/cluster.py ``rescheduler_taint_value``).
    """
    # clock.wall() on purpose (no monotonic fallback): the stamp is
    # compared across processes/replicas, and silently writing
    # seconds-since-boot would make another sweeper misjudge the
    # taint's age — a non-conforming Clock must fail loudly here
    taint = Taint(
        TO_BE_DELETED_TAINT,
        rescheduler_taint_value(identity, clock.wall()),
        "NoSchedule",
    )
    try:
        client.add_taint(node.name, taint)
    except Exception as err:  # noqa: BLE001 — any apiserver failure aborts
        recorder.event(
            "Node", node.name, "Warning", "ReschedulerFailed",
            f"failed to mark the node as draining/unschedulable: {err}",
        )
        raise DrainError(str(err)) from err
    recorder.event(
        "Node", node.name, "Normal", "Rescheduler",
        "marked the node as draining/unschedulable"
        + (
            f" (drain schedule step {schedule_step})"
            if schedule_step >= 0
            else ""
        ),
    )

    drain_successful = False
    try:
        retry_until = clock.now() + pod_eviction_timeout

        # Per-pod announcement before the first attempt (scaler.go:44).
        for pod in pods:
            recorder.event(
                "Pod", pod.uid, "Normal", "Rescheduler",
                "deleting pod from on-demand node",
            )

        # Eviction fan-out with the reference's retry cadence: every pod is
        # attempted in parallel (bounded pool standing in for scaler.go's
        # goroutine-per-pod, 93-113), then the failed set is retried each
        # retry period until the deadline (scaler.go:47-62).
        remaining: List[PodSpec] = list(pods)
        while remaining:
            with tracing.span(
                "drain.evict", pods=len(remaining),
                **({"schedule_step": schedule_step}
                   if schedule_step >= 0 else {}),
            ):
                remaining, err = _evict_round(
                    client, remaining, max_graceful_termination
                )
            if err is not None:
                last_error = err
            if remaining:
                if clock.now() + eviction_retry_time >= retry_until:
                    for pod in remaining:
                        recorder.event(
                            "Pod", pod.uid, "Warning", "ReschedulerFailed",
                            "failed to delete pod from on-demand node",
                        )
                    raise DrainError(
                        f"failed to drain node {node.name}, due to following "
                        f"errors: {last_error}"
                    )
                clock.sleep(eviction_retry_time)

        # Verification poll (scaler.go:119-144): all pods must be off the
        # node before the deadline. A pod observed gone is memoized (it
        # was evicted), so each round re-checks only the rest — and a
        # flaky GET marks only ITS pod as not-confirmed while the
        # remaining pods are still checked this round, instead of one
        # transient error burning the whole 5 s poll interval for all.
        # Success requires every gone verdict on the FINAL round: verdicts
        # memoized in earlier rounds get one fresh confirming read, so a
        # single anomalous observation (e.g. a stale-serving client
        # layer) cannot declare a still-running pod evicted and the node
        # drained. The common case — everything gone in one round — pays
        # no extra reads.
        gone: set = set()
        while clock.now() < retry_until + VERIFY_POLL_INTERVAL:
            fresh: set = set()  # gone verdicts observed THIS round
            with tracing.span(
                "drain.verify", remaining=len(pods) - len(gone)
            ):
                for pod in pods:
                    if pod.uid in gone:
                        continue
                    try:
                        returned = client.get_pod(pod.namespace, pod.name)
                    except Exception as err:  # noqa: BLE001 — scaler.go:129-133
                        log.error("Failed to check pod %s: %s", pod.uid, err)
                        continue  # only this pod counts as not-yet-gone
                    if returned is None or returned.node_name != node.name:
                        fresh.add(pod.uid)
                    else:
                        # expected while evictions propagate — the
                        # reference logs it at plain glog info
                        # (scaler/scaler.go:131-135), not error;
                        # vlog-gated here so proof artifacts and quiet
                        # production logs don't carry per-poll noise
                        log.vlog(2, "Not deleted yet %s", pod.name)
            confirmed = len(gone) + len(fresh) == len(pods)
            if confirmed:
                # re-confirm earlier rounds' memoized verdicts with one
                # fresh read each; a pod found back demotes to not-gone
                # and the poll continues
                for pod in pods:
                    if pod.uid in fresh or pod.uid not in gone:
                        continue
                    try:
                        returned = client.get_pod(pod.namespace, pod.name)
                    except Exception as err:  # noqa: BLE001
                        log.error(
                            "Failed to re-confirm pod %s: %s", pod.uid, err
                        )
                        gone.discard(pod.uid)
                        confirmed = False
                        continue
                    if returned is not None and returned.node_name == node.name:
                        log.error(
                            "Pod %s reappeared on %s after being observed "
                            "gone; resuming verification", pod.name, node.name,
                        )
                        gone.discard(pod.uid)
                        confirmed = False
            gone |= fresh
            if confirmed:
                log.vlog(4, "All pods removed from %s", node.name)
                drain_successful = True
                recorder.event(
                    "Node", node.name, "Normal", "Rescheduler",
                    "marked the node as drained/schedulable",
                )
                try:
                    client.remove_taint(node.name, TO_BE_DELETED_TAINT)
                except Exception as err:  # noqa: BLE001
                    log.error("Failed to clean taint on %s: %s", node.name, err)
                return
            clock.sleep(VERIFY_POLL_INTERVAL)
        raise DrainError(
            f"failed to drain node {node.name}: pods remaining after timeout"
        )
    finally:
        if not drain_successful:
            # deferred cleanup (scaler.go:83-88); cleanup failures must not
            # mask the original DrainError or crash the loop
            try:
                client.remove_taint(node.name, TO_BE_DELETED_TAINT)
            except Exception as err:  # noqa: BLE001
                log.error("Failed to clean taint on %s: %s", node.name, err)
            recorder.event(
                "Node", node.name, "Warning", "ReschedulerFailed",
                "failed to drain the node, aborting drain.",
            )
