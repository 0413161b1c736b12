"""Lease-based leader election for HA deployments.

The reference's Deployment runs **2 replicas** (deploy/deployment.yaml)
but its leader election was removed — the comment at reference
rescheduler.go:139 ("This is where the leader election used to be") and
the orphaned endpoints RBAC rule (deploy/clusterrole.yaml) are all that
remain, so both replicas plan and drain concurrently. This module restores
the missing piece the modern way: a ``coordination.k8s.io/v1`` Lease,
the same primitive client-go's leaderelection package uses today.

Semantics follow client-go's resourcelock loop, tick-driven instead of
threaded (the control loop calls :meth:`ensure` at the top of every
housekeeping tick, reference cadence 10 s):

- expiry is judged from **local observation time** — the instant *we* saw
  the holder's record last change — never by comparing another process's
  wall-clock timestamp against ours (clock-skew safety, the same rule
  client-go applies);
- every mutation is a compare-and-swap on ``metadata.resourceVersion``;
  losing the race (409 Conflict) means following, not crashing;
- a fresh takeover increments ``leaseTransitions`` and resets
  ``acquireTime``.

The wall-clock timestamps written into the Lease (``renewTime`` etc.) are
informational for ``kubectl describe`` parity; correctness never reads
them back.
"""

from __future__ import annotations

import datetime
import os
import socket
import threading
import time
import urllib.error
import uuid
from typing import Optional

from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock, RealClock

DEFAULT_LEASE_NAME = "k8s-spot-rescheduler-tpu"
DEFAULT_LEASE_NAMESPACE = "kube-system"
# client-go leaderelection defaults
DEFAULT_LEASE_DURATION = 15.0
# background renew cadence as a fraction of the lease duration —
# client-go's retryPeriod:leaseDuration ratio (2s : 15s)
RENEW_FRACTION = 2.0 / 15.0


def default_identity() -> str:
    return f"{socket.gethostname()}_{os.getpid()}_{uuid.uuid4().hex[:8]}"


def _micro_time(epoch: float) -> str:
    return (
        datetime.datetime.fromtimestamp(epoch, datetime.timezone.utc)
        .strftime("%Y-%m-%dT%H:%M:%S.%fZ")
    )


class LeaseElector:
    """Tick-driven leader election over a coordination.k8s.io Lease.

    ``client`` only needs the private ``_request`` plumbing of
    ``KubeClusterClient`` (GET/POST/PUT with JSON bodies raising
    ``urllib.error.HTTPError`` on failure).
    """

    def __init__(
        self,
        client,
        *,
        identity: str = "",
        name: str = DEFAULT_LEASE_NAME,
        namespace: str = DEFAULT_LEASE_NAMESPACE,
        lease_duration: float = DEFAULT_LEASE_DURATION,
        clock: Optional[Clock] = None,
        wall=time.time,
    ) -> None:
        self.client = client
        self.identity = identity or default_identity()
        self.name = name
        self.namespace = namespace
        self.lease_duration = float(lease_duration)
        self.clock = clock or RealClock()
        self.wall = wall
        self.is_leader = False
        # local-observation record for skew-safe expiry
        self._observed_spec: Optional[dict] = None
        self._observed_at: float = 0.0
        # ensure() may be called from both the control loop and the
        # background renew thread
        self._lock = threading.Lock()
        self._bg: Optional[threading.Thread] = None
        self._bg_stop = threading.Event()

    # --- API plumbing ---

    @property
    def _path(self) -> str:
        return (
            f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}"
            f"/leases/{self.name}"
        )

    def _get(self) -> Optional[dict]:
        try:
            # no transport-level retries: the elector's own renew cadence
            # IS its retry policy (ensure() demotes on error and recovers
            # next tick, like client-go leaderelection), and backoff
            # sleeps inside a renew would eat into the lease deadline
            return self.client._request("GET", self._path, retries=False)
        except urllib.error.HTTPError as err:
            if err.code == 404:
                return None
            raise

    def _create(self) -> bool:
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {"name": self.name, "namespace": self.namespace},
            "spec": self._my_spec(transitions=0, fresh_acquire=True),
        }
        try:
            self.client._request(
                "POST",
                f"/apis/coordination.k8s.io/v1/namespaces/{self.namespace}/leases",
                body,
            )
            return True
        except urllib.error.HTTPError as err:
            if err.code == 409:  # someone else created it first
                return False
            raise

    def _update(self, lease: dict, spec: dict) -> bool:
        body = {
            "apiVersion": "coordination.k8s.io/v1",
            "kind": "Lease",
            "metadata": {
                "name": self.name,
                "namespace": self.namespace,
                # CAS: stale resourceVersion -> 409 -> we lost the race
                "resourceVersion": lease.get("metadata", {}).get(
                    "resourceVersion", ""
                ),
            },
            "spec": spec,
        }
        try:
            self.client._request("PUT", self._path, body)
            return True
        except urllib.error.HTTPError as err:
            if err.code == 409:
                return False
            raise

    def _my_spec(self, transitions: int, fresh_acquire: bool,
                 prev: Optional[dict] = None) -> dict:
        now = _micro_time(self.wall())
        return {
            "holderIdentity": self.identity,
            "leaseDurationSeconds": int(self.lease_duration),
            "acquireTime": now if fresh_acquire else (
                (prev or {}).get("acquireTime", now)
            ),
            "renewTime": now,
            "leaseTransitions": transitions,
        }

    # --- the per-tick step ---

    def ensure(self) -> bool:
        """Acquire or renew leadership; returns whether this process may
        act this tick. Never raises on HTTP errors: any apiserver trouble
        demotes to follower (safe: a non-leader only skips work, matching
        the loop's level-triggered per-tick error handling)."""
        with self._lock:
            try:
                self.is_leader = self._ensure()
            except Exception as err:  # noqa: BLE001, exception-discipline — demotion IS the recorded outcome: is_leader flips false, the loop stands by, and the single-attempt lease read's failure already surfaced through the kube layer
                log.vlog(2, "leader election: demoted on error: %s", err)
                self.is_leader = False
            return self.is_leader

    # --- background renewal ---
    #
    # A tick can far outlast the lease: a drain blocks in the eviction
    # verify poll for up to pod_eviction_timeout (minutes), and a leader
    # that only renews at tick boundaries would go quiet mid-drain,
    # letting a standby take over and double-drain — the exact failure
    # the election exists to prevent. client-go renews from a background
    # goroutine for the same reason; so do we. The control loop reads
    # ``is_leader`` (kept fresh by this thread) at each tick boundary.

    def start_background(self, retry_period: Optional[float] = None) -> None:
        period = retry_period or self.lease_duration * RENEW_FRACTION
        self._bg_stop.clear()
        self._bg = threading.Thread(
            target=self._bg_loop, args=(period,),
            name="lease-renew", daemon=True,
        )
        self._bg.start()

    def stop_background(self) -> None:
        self._bg_stop.set()
        if self._bg is not None:
            self._bg.join(timeout=5)
            self._bg = None

    def _bg_loop(self, period: float) -> None:
        while not self._bg_stop.is_set():
            self.ensure()
            self._bg_stop.wait(period)

    def _ensure(self) -> bool:
        lease = self._get()
        if lease is None:
            if self._create():
                log.info("leader election: acquired lease %s/%s",
                         self.namespace, self.name)
                return True
            return False

        spec = lease.get("spec", {}) or {}
        holder = spec.get("holderIdentity", "")
        transitions = int(spec.get("leaseTransitions", 0) or 0)

        if holder == self.identity:
            # renew; a 409 means another replica stole it between our GET
            # and PUT — follow.
            renewed = self._update(
                lease, self._my_spec(transitions, fresh_acquire=False,
                                     prev=spec)
            )
            if not renewed:
                log.info("leader election: lost lease %s/%s on renew",
                         self.namespace, self.name)
            return renewed

        # another process holds the lease: judge expiry by when *we* last
        # observed the record change, not by its embedded timestamps.
        observed_key = {
            k: spec.get(k) for k in ("holderIdentity", "renewTime",
                                     "leaseTransitions")
        }
        if observed_key != self._observed_spec:
            self._observed_spec = observed_key
            self._observed_at = self.clock.now()
            return False
        duration = float(spec.get("leaseDurationSeconds")
                         or self.lease_duration)
        if self.clock.now() < self._observed_at + duration:
            return False
        # holder went quiet for a full lease duration: take over
        took = self._update(
            lease, self._my_spec(transitions + 1, fresh_acquire=True)
        )
        if took:
            log.info(
                "leader election: took lease %s/%s from quiet holder %s",
                self.namespace, self.name, holder,
            )
        return took
