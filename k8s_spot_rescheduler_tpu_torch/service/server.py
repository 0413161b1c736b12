"""The multi-tenant planner service: one card planning for a fleet.

The port of the JAX package's ``service/server.py``. A
card that serves one cluster is idle nearly all the time: the device
solve of a tick takes milliseconds, the housekeeping interval seconds.
So per-cluster agents (``service/agent.py``) ship their packed problems
here and a *batching scheduler* solves many tenants at once:

- agents POST packed problems over the binary wire protocol
  (``service/wire.py``, byte-identical to the JAX package's) to
  ``/v2/plan``;
- concurrent requests are padded into shape buckets
  (``service/buckets.py``) and stacked into ONE batched solve
  (``parallel/tenant_batch.py``): first-fit as one launch of kernel
  B1t and best-fit as one launch of B2t over a (lane block, tenant)
  grid, repair per tenant where greedy left a lane unproven, and one
  fetch of the [T, 3+K] selections; the batch size is capped by the
  device-memory estimate of ``solver/memory``;
- a deficit-round-robin queue gives per-tenant fairness: each batch
  round offers every waiting tenant one lane-block's worth of quantum,
  so a tenant flooding the queue delays only itself;
- the wait is bounded: a request still queued past the queue timeout is
  evicted with 503 + ``Retry-After`` from the *measured* batch cadence;
- delta wire (v4): a per-tenant cache of fingerprinted packed state
  takes an agent's churn delta instead of its full pack, the batch's
  deltas scattered on the card in one pass
  (``parallel/tenant_batch.apply_tenant_deltas``); any disagreement is
  answered with a typed RESYNC, never a wrong plan; full-pack resync
  ingests have their own bounded admission class;
- the JSON ``/v1/plan`` is a decode -> pack adapter over the same queue,
  so there is one solve path; ``max_body_bytes`` caps a body (413),
  ``max_inflight`` caps handler depth with rejects before the body is
  read.

``GET /healthz`` reports queue depth, per-bucket occupancy, per-tenant
last-plan age, the measured cadence, the batch program and the
device-health verdict beside the control-loop health snapshot.

Failure domains:

- a **device-health watchdog** (``service/devhealth.py``) times every
  batched device solve against a calibrated baseline and runs idle
  canaries; a slow or failing device is reported (``/healthz``
  ``device: "sick"``, the ``service_device_sick`` gauge, a
  ``device-sick`` flight event) until hysteresis probes pass. Off the
  card the sick service serves its numpy-oracle host path meanwhile, as
  the JAX package does; on a cuda service the verdict is a report only:
  every batch stays on the card's kernels, each solve while sick counts
  as a probe, and a failing solve fails its batch typed;
- a **fault of the card's kernels** (build, load, launch, CUDA error:
  ``ops/ffd_kernels.is_device_fault``) is not a watchdog verdict: it
  fails its batch and ends the service (``ServiceFault``; the CLI exits
  non-zero), as it ends the controller, so no batch moves to the host
  or to the plain versions because a kernel failed. The kernel library
  is built and loaded before the service listens (``prepare``), so an
  agent's first request never waits on ``nvcc``;
- **graceful drain**: SIGTERM (``ServiceServer.graceful_shutdown``)
  stops admitting (503 + Retry-After), finishes queued batches within
  ``service_drain_grace``, persists the warm state, then exits;
- **warm restart**: per-tenant last-pack fingerprints and the
  recently-used bucket list persist to ``service_state_dir``, in the JAX
  package's file format; a restarted replica pre-runs those buckets.

Threads: HTTP handlers decode, enqueue and wait; the batching scheduler
thread (``start_scheduler``) assembles, scatters and solves, with the
service's CUDA device set on it. Without a scheduler thread
(``drain_once`` from the caller: the virtual-clock seam of the tests and
of in-process callers) the caller's thread solves. The tenant mesh: with more
than one of its ``devices`` (every visible card by default), a batch's
tenant axis is padded with inert all-zero tenants to a multiple of the
mesh (``_pad_tenant_axis``) and split into one block a device
(``parallel/tenant_batch``); the pads are sliced off before any reply.

Debug surface (``debug_endpoints``, ``--debug-endpoints``; off by
default, and then both paths answer 404): ``GET /debug/trace`` answers
the flight recorder's last tick tree and the last 32 requests' server
span blocks keyed by the agent's trace ID (``note_request_trace``, the
tenant id hashed), ``GET /debug/flight`` the redacted ring summary
(``?dump=1`` also writes a postmortem) — ``loop/flight.py``'s redaction
policy, as in the JAX package.

Chaos (``service/chaos.py``, ``--service-chaos-profile``): a seeded
``ServiceChaos`` runs inside the timed solve window (``on_batch``:
scripted solve errors, the sick phase's extra latency on the service
clock) and ahead of the wire decode (``corrupt_request``: a 400, never a
crash). A scripted solve error is not a fault of the card's kernels: it
fails its batch typed and the service keeps serving; the sick phase
flips the watchdog, which on a cuda service only reports.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import socket
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    host_array,
    to_numpy,
)
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
    LAUNCHES,
    is_device_fault,
)
from k8s_spot_rescheduler_tpu_torch.parallel.mesh import (
    default_devices,
    make_tenant_mesh,
)
from k8s_spot_rescheduler_tpu_torch.parallel.tenant_batch import (
    apply_tenant_deltas,
    make_tenant_batch_planner,
    make_tenant_schedule_planner,
)
from k8s_spot_rescheduler_tpu_torch.service import buckets as bucketing
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.service.buckets import Bucket
from k8s_spot_rescheduler_tpu_torch.service.devhealth import DeviceHealthWatchdog
from k8s_spot_rescheduler_tpu_torch.solver import memory
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock, RealClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing


class ServiceBusy(Exception):
    """The queue refused or expired a request; retry after ``retry_after``
    seconds (the measured batch cadence, ceil'd)."""

    def __init__(self, message: str, retry_after: int):
        super().__init__(message)
        self.retry_after = int(retry_after)


class ServiceFault(RuntimeError):
    """A fault of the card's kernels ended the service: the batch that
    met it failed, and no later batch is taken."""


class ResyncRequired(Exception):
    """A delta request's base state is unusable (restart, eviction,
    fingerprint mismatch, decode/apply anomaly): the agent must answer
    with exactly one full pack. Typed so the HTTP layer encodes it as
    wire ``KIND_RESYNC`` (HTTP 200 — a resync is protocol, not an
    endpoint failure; a 4xx/5xx would trip the agent's breaker and
    read as a dead replica)."""


# per-tenant bookkeeping bounds: tenant ids are CLIENT-supplied (wire
# frame / X-Tenant header), so every keyed structure must be pruned or a
# churning fleet (fresh hostname per agent restart) grows the long-lived
# service without bound
TENANT_STATE_TTL_S = 3600.0
TENANT_STATE_MAX = 4096

# warm-restart state (service_state_dir): file name, save cadence, and
# how many recently-used buckets a restarted replica pre-warms
STATE_FILE = "planner_warm_state.json"
STATE_SAVE_INTERVAL_S = 60.0
WARM_MAX_BUCKETS = 8
SEEN_BUCKETS_MAX = 64

# delta-wire tenant cache (wire v4): per-tenant packed state is a whole
# bucket-padded tensor set — far heavier than the bookkeeping maps — so
# it carries its own, tighter hard cap (eviction is cheap for the
# evictee: one full-pack resync on its next delta)
TENANT_CACHE_MAX = 512

# batches whose time split ``PlannerService.batch_log`` keeps
BATCH_LOG_MAX = 256


class _TenantEntry:
    """One tenant's cached packed state for the delta wire: the host
    mirror (bucket-padded, owned writable arrays — deltas scatter into
    it in place), the device-resident twin on the accelerator path
    (populated after the tenant's first batched scatter; None on the
    numpy path and after a device error), and the content fingerprint
    the next delta's base must name."""

    __slots__ = ("fp", "host", "device", "bucket", "K", "lanes",
                 "last_used")

    def __init__(self, fp, host, bucket, K, lanes, last_used):
        self.fp = fp
        self.host = host  # PackedCluster of writable numpy arrays
        self.device = None  # PackedCluster of device arrays, or None
        self.bucket = bucket
        self.K = int(K)  # the agent's own K (reply row trim)
        self.lanes = int(lanes)  # valid lanes (DRR cost of a delta req)
        self.last_used = float(last_used)


class _Request:
    __slots__ = (
        "tenant", "packed", "bucket", "lanes", "enqueued", "event",
        "reply", "error", "trace_id", "horizon", "fingerprint", "K",
        "delta", "base_fp", "new_fp", "resync",
    )

    def __init__(self, tenant: str, packed: Optional[PackedCluster],
                 bucket: Bucket, enqueued: float, trace_id: str = "",
                 horizon: int = 0, fingerprint: str = "", lanes: int = 0,
                 K: int = 0):
        self.tenant = tenant
        self.packed = packed
        self.bucket = bucket
        # drain-schedule horizon (wire v3): 0 = ordinary single plan;
        # > 0 = answer with a whole [horizon, 3+K] schedule. Requests
        # only batch with same-horizon peers (one program per batch).
        self.horizon = int(horizon)
        # DRR cost: the lanes this problem actually solves (valid lanes,
        # not pad) — a tenant shipping big problems drains its deficit
        # faster than one shipping small ones. Delta requests (packed
        # None) have the caller compute it from the cached state.
        if packed is not None:
            self.lanes = int(np.asarray(packed.cand_valid).sum())
            self.K = packed.slot_req.shape[1]
        else:
            self.lanes = int(lanes)
            self.K = int(K)
        self.enqueued = enqueued
        self.event = threading.Event()
        self.reply: Optional[wire.PlanReply] = None
        self.error: Optional[ServiceBusy] = None
        # the agent's tick trace ID (wire v2 / X-Trace-Id): server-side
        # spans are keyed by it so the reply's span block grafts into
        # the right tick tree on the far side
        self.trace_id = trace_id
        # delta wire (v4): the pack fingerprint a full-pack request
        # carries (seeds the tenant cache), or the churn payload +
        # base/new fingerprints of a delta-backed request; ``resync``
        # carries the demand's cause when the batch path refused the
        # delta after it was queued
        self.fingerprint = fingerprint
        self.delta = None
        self.base_fp = ""
        self.new_fp = ""
        self.resync: Optional[str] = None


class PlannerService:
    """The queue + batcher + solver. HTTP lives in :class:`ServiceServer`;
    this class is directly drivable by tests (virtual clock, no threads:
    ``submit_nowait`` + ``drain_once``)."""

    def __init__(
        self,
        config: ReschedulerConfig,
        *,
        queue_timeout_s: Optional[float] = None,
        batch_window_s: Optional[float] = None,
        max_batch_tenants: int = 0,
        clock: Optional[Clock] = None,
        device=None,
        devices=None,
    ):
        self.config = config
        self.clock = clock or RealClock()
        # where batches solve: ``device`` (default cuda; raises without
        # a card), or the host for solver="numpy"
        self.device = (
            torch.device("cpu")
            if config.solver == "numpy"
            else resolve_device(device)
        )
        if self.device.type == "cuda" and self.device.index is None:
            # the scheduler thread sets its device by index
            self.device = torch.device("cuda", torch.cuda.current_device())
        # the tenant mesh's devices (every visible card for a cuda
        # service, else the CPU; a list may name one card several
        # times); more than one lays batches over a tenant mesh
        self.devices = (
            [self.device] if config.solver == "numpy"
            else list(devices) if devices is not None
            else default_devices(self.device)
        )
        self._mesh = None
        self._mesh_ready = False
        # the fault of the card's kernels that ended the service, and
        # the callbacks told of it (ServiceServer stops serving)
        self.fatal: Optional[BaseException] = None
        self.on_fatal: List = []
        # per-batch time split (queue wait, assemble, delta scatter,
        # solve, fetch, reply) and kernel launches, newest last
        self.batch_log: deque = deque(maxlen=BATCH_LOG_MAX)
        self.queue_timeout_s = float(
            queue_timeout_s
            if queue_timeout_s is not None
            else config.service_queue_timeout
        )
        self.batch_window_s = float(
            batch_window_s
            if batch_window_s is not None
            else config.service_batch_window
        )
        # 0 = derive per bucket from the HBM budget
        self.max_batch_tenants = int(max_batch_tenants)
        self._lock = threading.Lock()
        self._work = threading.Condition(self._lock)
        self._queues: Dict[str, deque] = {}  # tenant -> FIFO of _Request
        self._ring: List[str] = []  # DRR ring, activation order
        self._rr_pos = 0
        self._deficit: Dict[str, int] = {}
        self._last_plan_wall: Dict[str, float] = {}
        self._batch_cap: Dict[Bucket, int] = {}  # HBM cap memo per bucket
        self._cadence_s: Optional[float] = None  # EMA of batch intervals
        self._last_batch_mono: Optional[float] = None
        self._batched = None  # lazy tenant-batch program
        self._sched_programs: Dict[int, object] = {}  # horizon -> program
        # delta wire (v4): per-tenant fingerprinted packed state; the
        # batch's deltas scatter on the card; _warm_fps holds the
        # RESTART-persisted fingerprints (content is gone — they only
        # name the resync cause precisely)
        self._tenant_cache: Dict[str, _TenantEntry] = {}
        self._warm_fps: Dict[str, str] = {}
        self._stop = False
        self._draining = False
        self._thread: Optional[threading.Thread] = None
        # test seam: solve_hook(stacked, reqs) -> int32 [T, 3+K]. When
        # set it IS the device path: the watchdog times it and, off the
        # card, the sick flip routes around it, exactly as for the real
        # device solve.
        self.solve_hook = None
        # device-health watchdog (lazy; None while device_sick_threshold
        # is 0) + the server-side chaos hook (None outside chaos runs)
        self._devhealth: Optional[DeviceHealthWatchdog] = None
        self.chaos = None
        if config.service_chaos_profile not in ("", "off", "none"):
            from k8s_spot_rescheduler_tpu_torch.service.chaos import (
                ServiceChaos,
                ServiceFaultPlan,
            )

            self.chaos = ServiceChaos(
                ServiceFaultPlan.profile(
                    config.service_chaos_profile,
                    config.service_chaos_seed,
                ),
                clock=self.clock,
            )
        # warm-restart bookkeeping: recently-used bucket shapes (dims ->
        # last-used wall) and per-tenant last-pack fingerprints, both
        # bounded, persisted to service_state_dir
        self._seen_buckets: Dict[tuple, float] = {}
        self._tenant_bucket: Dict[str, str] = {}
        self._last_state_save: Optional[float] = None
        self.warmed_buckets: List[str] = []
        # stacked shapes whose program has already run once: the FIRST
        # solve of a shape sets up its launch geometry (occupancy query,
        # shared-memory allowance, allocator growth) and must not be
        # judged (or baselined) as device latency by the watchdog
        self._timed_shapes: set = set()
        # shape-family accounting, independent of the watchdog's
        # _timed_shapes (which deliberately does NOT advance on the
        # sick/host path): every batch counts a hit or a miss against
        # the shapes THIS process has solved, whatever path served it
        self._compile_seen: set = set()

    # ------------------------------------------------------------------
    # queue

    def submit_nowait(
        self,
        tenant: str,
        packed: PackedCluster,
        trace_id: str = "",
        schedule_horizon: int = 0,
        pack_fingerprint: str = "",
    ) -> _Request:
        """Enqueue one problem; returns the pending request (its
        ``event`` fires when a batch delivered ``reply`` or ``error``)."""
        req = _Request(
            tenant, packed, bucketing.bucket_for(packed), self.clock.now(),
            trace_id=trace_id, horizon=schedule_horizon,
            fingerprint=pack_fingerprint,
        )
        self._enqueue(req)
        return req

    def _enqueue(self, req: _Request) -> None:
        with self._work:
            if self.fatal is not None:
                raise ServiceBusy(
                    f"service ended by a fault of the card's kernels: "
                    f"{self.fatal}", 0,
                )
            if self._draining:
                # graceful drain: stop admitting; the Retry-After horizon
                # is the drain grace (by then this replica is gone and a
                # failover endpoint or a fresh replica answers)
                raise ServiceBusy(
                    "service draining (graceful shutdown); retry another "
                    "replica",
                    self.drain_retry_after(),
                )
            q = self._queues.get(req.tenant)
            if q is None:
                q = self._queues[req.tenant] = deque()
            if req.tenant not in self._deficit:
                self._ring.append(req.tenant)
                self._deficit[req.tenant] = 0
            q.append(req)
            self._work.notify_all()

    def submit(
        self,
        tenant: str,
        packed: PackedCluster,
        timeout_s: Optional[float] = None,
        trace_id: str = "",
        schedule_horizon: int = 0,
        pack_fingerprint: str = "",
    ):
        """Enqueue and wait for the batch that carries this request.
        Raises :class:`ServiceBusy` when the bounded wait expires — the
        request is evicted from the queue so an abandoned caller cannot
        occupy a batch slot. ``timeout_s`` is the CLIENT's declared
        deadline (agents send it as ``X-Planner-Deadline``): waiting any
        longer than the caller will would solve — and hold an inflight
        slot for — a request nobody is listening to anymore. Returns a
        :class:`wire.PlanReply`, or a :class:`wire.PlanScheduleReply`
        when ``schedule_horizon`` > 0 asked for a drain schedule."""
        wait_s, capped = self._bounded_wait(timeout_s)
        req = self.submit_nowait(
            tenant, packed, trace_id=trace_id,
            schedule_horizon=schedule_horizon,
            pack_fingerprint=pack_fingerprint,
        )
        return self._finish_wait(req, wait_s, deadline_capped=capped)

    def _bounded_wait(self, timeout_s: Optional[float]):
        """(wait_s, deadline_capped): the queue timeout, shortened to
        the client's declared deadline when that is tighter — the flag
        names which bound an eventual eviction was shed under."""
        wait_s = self.queue_timeout_s
        if timeout_s is not None and 0 < float(timeout_s) < wait_s:
            return max(0.05, float(timeout_s)), True
        return wait_s, False

    def _note_shed(
        self, reason: str, cause: str, tenant: str = "", trace_id: str = "",
        kind: str = "service-shed",
    ) -> None:
        """ONE request shed at an admission edge: fire the labeled
        ``service_admission_shed_total`` counter and the flight shed
        event (same reason attr) from this single funnel, one call site
        per reason, so the two surfaces can be asserted equal per
        reason. ``kind`` defaults to
        ``service-shed``; the resync-storm admission edge fires its
        dedicated ``resync-shed`` flight kind through the same
        funnel."""
        metrics.update_service_admission_shed(reason)
        attrs = {"reason": reason}
        if tenant:
            attrs["tenant"] = tenant
        flight.note_event(kind, cause=cause, trace_id=trace_id, **attrs)

    def _finish_wait(
        self, req: _Request, wait_s: float, deadline_capped: bool = False
    ):
        """The shared bounded wait behind :meth:`submit` and
        :meth:`submit_delta`: inline drain for scheduler-less callers,
        eviction past the deadline, and the typed outcomes.
        ``deadline_capped`` names which bound an eviction sheds under —
        the client's declared deadline vs the service queue timeout."""
        if self._thread is None:
            # no scheduler thread (an in-process caller — e.g.
            # PlannerSidecar.plan without start_background): drain the
            # queue on the caller's thread so the historical synchronous
            # contract holds instead of timing out against nobody
            while not req.event.is_set() and self.drain_once():
                pass
        if not req.event.wait(wait_s):
            if self._evict(req):
                metrics.update_service_request("expired")
                metrics.update_service_tenant_eviction(req.tenant)
                if deadline_capped:
                    self._note_shed(
                        "deadline",
                        "plan request outlived the client's %.1fs "
                        "declared deadline" % wait_s,
                        tenant=req.tenant, trace_id=req.trace_id,
                    )
                else:
                    self._note_shed(
                        "queue-timeout",
                        "plan request waited past the %.1fs queue "
                        "timeout" % wait_s,
                        tenant=req.tenant, trace_id=req.trace_id,
                    )
                raise ServiceBusy(
                    "plan request waited past the %.1fs queue timeout"
                    % wait_s,
                    self.retry_after(),
                )
            # already popped into an in-flight batch: the solve is not
            # interruptible (a launched kernel cannot be cancelled), so
            # ride it out — same contract as the old sidecar lock
            req.event.wait()
        if req.resync is not None:
            raise ResyncRequired(req.resync)
        if req.error is not None:
            raise req.error
        if req.reply is None:
            raise RuntimeError("request completed without reply or error")
        return req.reply

    def _evict(self, req: _Request) -> bool:
        with self._work:
            q = self._queues.get(req.tenant)
            if q is not None and req in q:
                q.remove(req)
                return True
        return False

    # ------------------------------------------------------------------
    # delta wire (v4): fingerprinted tenant cache + resync demands

    def note_resync(self, tenant: str, cause: str, trace_id: str = "") -> None:
        """ONE resync demanded: fire the metric and the flight event
        from this single site so ``service_delta_requests_total``
        {outcome=resync} and the flight ``delta-resync`` count can
        never disagree."""
        metrics.update_service_delta("resync")
        flight.note_event(
            "delta-resync", cause=cause, trace_id=trace_id, tenant=tenant,
        )
        log.warning(
            "delta resync demanded for tenant %s: %s",
            flight.redact_text(tenant) if tenant else "<undecoded>", cause,
        )

    def _cache_mismatch_locked(
        self, tenant: str, entry: Optional[_TenantEntry], base_fp: str
    ) -> Optional[str]:
        """Why this delta cannot apply (None = it can). Caller holds
        the lock."""
        if entry is None:
            if self._warm_fps.get(tenant) == base_fp:
                return (
                    "server restart lost the cached tenant state (the "
                    "persisted warm fingerprint matches the delta base)"
                )
            return "no cached state for tenant (first contact or evicted)"
        if entry.fp != base_fp:
            return (
                f"fingerprint mismatch (cache holds {entry.fp[:12]}..., "
                f"delta base names {base_fp[:12]}...)"
            )
        return None

    @staticmethod
    def _validate_delta(delta, bucket: Bucket) -> Optional[str]:
        """Range-check a decoded delta against the cached bucket shape
        (the wire digest already proves the bytes are as sent; this
        guards a buggy agent — numpy would silently WRAP a negative
        index where the device scatter drops it, so refuse both)."""
        if delta.lane_slot_req.shape[1] > bucket.K:
            return (
                f"delta lane slabs carry K={delta.lane_slot_req.shape[1]} "
                f"> cached bucket K={bucket.K}"
            )
        for name, idx, n in (
            ("lanes", delta.lanes, bucket.C),
            ("cand_rows", delta.cand_rows, bucket.C),
            ("spot_rows", delta.spot_rows, bucket.S),
        ):
            if len(idx) and (
                int(idx.min()) < 0 or int(idx.max()) >= n
            ):
                return f"delta {name} index out of range [0, {n})"
        return None

    def submit_delta(
        self,
        tenant: str,
        delta,
        base_fp: str,
        new_fp: str,
        timeout_s: Optional[float] = None,
        trace_id: str = "",
    ):
        """Enqueue one delta-backed plan request and wait for the batch
        that carries it. Raises :class:`ResyncRequired` when the cached
        base state cannot honor the delta (fast-path check here; the
        authoritative re-check happens at batch assembly, since an
        earlier queued delta may advance the cache first), or
        :class:`ServiceBusy` exactly like :meth:`submit`. Returns a
        :class:`wire.PlanReply` — the selection is computed from the
        cached state with this delta scattered in, bit-identical to the
        same tenant shipping its full pack."""
        with self._work:
            entry = self._tenant_cache.get(tenant)
            cause = self._cache_mismatch_locked(tenant, entry, base_fp)
            if cause is None:
                cause = self._validate_delta(delta, entry.bucket)
            if cause is None:
                # DRR lane cost of the resulting state, computed from
                # the delta alone: cached lanes minus the flips the
                # cand_valid section reverts, plus the ones it sets
                old = np.asarray(
                    entry.host.cand_valid[np.asarray(delta.cand_rows)]
                )
                lanes = (
                    entry.lanes
                    - int(old.sum())
                    + int(np.asarray(delta.cand_valid).sum())
                )
                req = _Request(
                    tenant, None, entry.bucket, self.clock.now(),
                    trace_id=trace_id, lanes=lanes, K=entry.K,
                )
                req.delta = delta
                req.base_fp = base_fp
                req.new_fp = new_fp
        if cause is not None:
            self.note_resync(tenant, cause, trace_id)
            raise ResyncRequired(cause)
        self._enqueue(req)
        wait_s, capped = self._bounded_wait(timeout_s)
        return self._finish_wait(req, wait_s, deadline_capped=capped)

    def tenant_cached(self, tenant: str) -> bool:
        """Whether this tenant currently has delta-wire state cached —
        the resync admission class keys on it: a fingerprinted full
        pack from an UNCACHED tenant is a cache-seeding resync ingest
        (first contact or post-restart re-seed); cached tenants and
        delta traffic bypass the resync gate entirely."""
        with self._work:
            return tenant in self._tenant_cache

    def invalidate_tenant_cache(self, tenant: Optional[str] = None) -> int:
        """Drop one tenant's (or every) cached packed state; their next
        delta is answered with a resync demand. The forced-resync seam
        serve-smoke drives; eviction/TTL pruning reuses it."""
        with self._work:
            if tenant is not None:
                n = 1 if self._tenant_cache.pop(tenant, None) else 0
            else:
                n = len(self._tenant_cache)
                self._tenant_cache.clear()
            metrics.update_service_tenant_cache(len(self._tenant_cache))
        return n

    def retry_after(self) -> int:
        """Seconds until a batch slot plausibly frees: the measured
        batch cadence (EMA over completed batches), ceil'd; 1 before
        any batch has completed."""
        cadence = self._cadence_s
        if cadence is None or cadence <= 0:
            return 1
        return max(1, int(math.ceil(cadence)))

    def queue_depth(self) -> int:
        with self._work:
            return sum(len(q) for q in self._queues.values())

    def healthz_snapshot(self) -> dict:
        """Queue depth, per-bucket occupancy, per-tenant last-plan age,
        the measured cadence, the drain flag and the device-health
        verdict — the service half of /healthz."""
        wd = self._watchdog()  # takes (and releases) the lock itself
        with self._work:
            depth = 0
            by_bucket: Dict[str, int] = {}
            for q in self._queues.values():
                depth += len(q)
                for req in q:
                    key = req.bucket.key
                    by_bucket[key] = by_bucket.get(key, 0) + 1
            wall = self.clock.wall()
            tenants = {
                t: round(max(0.0, wall - w), 3)
                for t, w in self._last_plan_wall.items()
            }
            cadence = self._cadence_s
            draining = self._draining
            cache_entries = len(self._tenant_cache)
        out = {
            "queue_depth": depth,
            "bucket_occupancy": by_bucket,
            "tenant_last_plan_age_s": tenants,
            "batch_cadence_s": (
                None if cadence is None else round(cadence, 3)
            ),
            "batch_window_s": self.batch_window_s,
            "draining": draining,
            "tenant_cache_entries": cache_entries,
            # windowed queue-wait percentiles (pooled + the worst
            # tenants' tails): a probe sees a starving tenant NOW, not
            # its worst-ever (metrics/registry.py bounded rings)
            "queue_wait_ms": metrics.service_queue_wait_summary(),
        }
        if wd is not None:
            out.update(wd.snapshot())
        else:
            out["device"] = "unwatched"  # device_sick_threshold = 0
        return out

    # ------------------------------------------------------------------
    # batching

    def _pop_batch_locked(self):
        """One deficit-round-robin pass: pick the bucket of the oldest
        waiting request (bounded wait beats throughput), then walk the
        tenant ring giving each tenant one quantum (a full lane-block,
        ``bucket.C`` lanes) and popping head requests of that bucket
        while its deficit covers their lane cost. Caller holds the lock."""
        oldest: Optional[_Request] = None
        for q in self._queues.values():
            if q and (oldest is None or q[0].enqueued < oldest.enqueued):
                oldest = q[0]
        if oldest is None:
            return []
        bucket = oldest.bucket
        # schedule requests (horizon > 0) solve a different program per
        # horizon: a batch only ever mixes same-(bucket, horizon) peers
        horizon = oldest.horizon
        cap = self.max_batch_tenants or self._batch_cap.get(bucket, 0)
        if not cap:
            # memoized per bucket: the estimate is constant in (bucket,
            # config), and it queries the card's memory — not something
            # to repeat per pop under the queue lock
            cap = bucketing.max_batch_tenants(
                bucket,
                budget_bytes=self.config.solver_hbm_budget,
                device=self.device,
                repair_spot_chunks=(
                    1
                    if self.config.fallback_best_fit
                    and self.config.repair_rounds > 0
                    else 0
                ),
            )
            self._batch_cap[bucket] = cap
        batch: List[_Request] = []
        # refill each waiting tenant's deficit ONCE per batch: one full
        # lane-block of quantum. quantum >= any request's lane cost, so
        # every tenant is guaranteed a slot in the very next batch — the
        # bounded-wait fairness claim — while lane accounting still lets
        # small-problem tenants pack denser than big-problem ones.
        refilled: set = set()
        while len(batch) < cap:
            popped = False
            # one full ring rotation, ONE pop per tenant per pass:
            # interleaving is what keeps a flooding tenant from filling
            # the batch before the rotation reaches anyone else
            for _ in range(len(self._ring)):
                if len(batch) >= cap or not self._ring:
                    break
                self._rr_pos %= len(self._ring)
                tenant = self._ring[self._rr_pos]
                q = self._queues.get(tenant)
                if not q:
                    # empty queue leaves the ring AND the queue map;
                    # deficit resets (classic DRR: credit must not
                    # accrue while idle) and a churned tenant id leaves
                    # no residue behind
                    self._ring.pop(self._rr_pos)
                    self._deficit.pop(tenant, None)
                    self._queues.pop(tenant, None)
                    continue
                if q[0].bucket == bucket and q[0].horizon == horizon:
                    if tenant not in refilled:
                        refilled.add(tenant)
                        # clamp: credit saved while batches were full
                        # must not compound into a later burst
                        self._deficit[tenant] = min(
                            self._deficit.get(tenant, 0) + bucket.C,
                            2 * bucket.C,
                        )
                    if self._deficit[tenant] >= max(q[0].lanes, 1):
                        req = q.popleft()
                        self._deficit[tenant] -= max(req.lanes, 1)
                        batch.append(req)
                        popped = True
                self._rr_pos += 1
            if not popped:
                break
        return batch

    def drain_once(self) -> bool:
        """Form and solve ONE batch; returns True if a batch dispatched.
        The scheduler thread loops this; tests call it directly under a
        virtual clock. A fault of the card's kernels fails the batch and
        ends the service: ``ServiceFault`` is raised, here and on every
        later call."""
        if self.fatal is not None:
            raise ServiceFault(str(self.fatal)) from self.fatal
        with self._work:
            queued = sum(len(q) for q in self._queues.values())
            batch = self._pop_batch_locked()
        if not batch:
            return False
        bucket = batch[0].bucket
        t0 = self.clock.now()
        # the batch's time split on the host clock (a measurement, not
        # the service clock, which tests run virtual)
        split = {"t0": time.perf_counter()}
        launches = dict(LAUNCHES)
        try:
            batch, stacked = self._assemble_batch(batch, bucket, split)
            if not batch:
                # every member resynced away (already answered typed)
                return True
            now = self.clock.now()
            waits_ms = [max(0.0, now - r.enqueued) * 1e3 for r in batch]
            t_solve = self.clock.now()
            split["t_solve"] = time.perf_counter()
            out = self._solve_batch(stacked, batch, split)
        except Exception as err:  # noqa: BLE001 — contain: fail the batch,
            # not the service (the agents fall back to their local oracle);
            # counted via update_service_request("error") below. A fault
            # of the card's kernels is not contained: it ends the service.
            log.error("batched solve failed: %s", err)
            for req in batch:
                if req.event.is_set():
                    continue  # already answered (a typed resync)
                req.error = ServiceBusy(f"solve failed: {err}", 0)
                metrics.update_service_request("error")
                req.event.set()
            if is_device_fault(err):
                self._fail(err)
                raise ServiceFault(str(err)) from err
            return True
        batch_ms = (t_solve - t0) * 1e3
        solve_wall_ms = (self.clock.now() - t_solve) * 1e3
        solve_ms = (self.clock.now() - t0) * 1e3
        lanes = sum(r.lanes for r in batch)
        tenants = len({r.tenant for r in batch})
        cap = self.max_batch_tenants or self._batch_cap.get(bucket, 0)
        metrics.update_service_batch(
            lanes, tenants,
            [(r.tenant, w) for r, w in zip(batch, waits_ms)],
            occupancy=(len(batch) / cap if cap else None),
        )
        wall = self.clock.wall()
        end = self.clock.now()
        with self._work:
            # bookkeeping a concurrent /healthz iterates — same lock
            for req in batch:
                self._last_plan_wall[req.tenant] = wall
                # warm-restart fingerprint: the bucket this tenant's
                # last pack landed in (persisted to service_state_dir)
                self._tenant_bucket[req.tenant] = bucket.key
            self._seen_buckets[tuple(bucket)] = wall
            if len(self._seen_buckets) > SEEN_BUCKETS_MAX:
                oldest = min(self._seen_buckets, key=self._seen_buckets.get)
                del self._seen_buckets[oldest]
            # bounded: tenant ids are client-supplied, so the age map
            # drops entries past the TTL and hard-caps at the newest
            # TENANT_STATE_MAX (a churning fleet must not grow the
            # service or its /healthz response without bound)
            cutoff = wall - TENANT_STATE_TTL_S
            stale = [
                t for t, w in self._last_plan_wall.items() if w < cutoff
            ]
            for t in stale:
                del self._last_plan_wall[t]
            if len(self._last_plan_wall) > TENANT_STATE_MAX:
                newest = sorted(
                    self._last_plan_wall.items(),
                    key=lambda kv: kv[1],
                    reverse=True,
                )[:TENANT_STATE_MAX]
                self._last_plan_wall = dict(newest)
            if len(self._tenant_bucket) > len(self._last_plan_wall):
                self._tenant_bucket = {
                    t: b
                    for t, b in self._tenant_bucket.items()
                    if t in self._last_plan_wall
                }
            # the delta-wire tenant cache rides the same lifecycle —
            # TTL'd tenants lose their cached packed state, and a
            # tighter hard cap evicts the least-recently-used entries
            # (packed state is far heavier than the bookkeeping maps);
            # an evicted tenant's next delta costs one full-pack resync
            if self._tenant_cache:
                for t in [
                    t for t in self._tenant_cache
                    if t not in self._last_plan_wall
                ]:
                    del self._tenant_cache[t]
                if len(self._tenant_cache) > TENANT_CACHE_MAX:
                    newest = sorted(
                        self._tenant_cache.items(),
                        key=lambda kv: kv[1].last_used,
                        reverse=True,
                    )[:TENANT_CACHE_MAX]
                    self._tenant_cache = dict(newest)
                metrics.update_service_tenant_cache(
                    len(self._tenant_cache)
                )
            if self._last_batch_mono is not None:
                interval = max(1e-9, end - self._last_batch_mono)
                self._cadence_s = (
                    interval
                    if self._cadence_s is None
                    else 0.7 * self._cadence_s + 0.3 * interval
                )
            self._last_batch_mono = end
        split["t_replies"] = time.perf_counter()
        for i, req in enumerate(batch):
            K = req.K
            vec = out[i]
            # server-side spans, offset from THIS request's enqueue:
            # how its wall time split between the tenant queue, the
            # bucket pad/stack, and the shared solve. The HTTP layer
            # prepends admit/decode and appends encode; the agent
            # grafts the whole block under its wire.request span.
            spans = (
                tracing.make_span("service.queue-wait", 0.0, waits_ms[i]),
                tracing.make_span("service.batch", waits_ms[i], batch_ms),
                tracing.make_span(
                    "service.solve", waits_ms[i] + batch_ms, solve_wall_ms
                ),
            )
            if req.horizon > 0:
                # a whole drain schedule (wire v3): trim the bucket's K
                # pad per step — the slot columns beyond the tenant's
                # own K are pad rows, exactly as for a single plan
                req.reply = wire.PlanScheduleReply(
                    steps=np.ascontiguousarray(
                        np.concatenate(
                            [vec[:, :3], vec[:, 3 : 3 + K]], axis=1
                        ).astype(np.int32)
                    ),
                    solve_ms=float(solve_ms / max(len(batch), 1)),
                    queue_wait_ms=float(waits_ms[i]),
                    batch_lanes=lanes,
                    batch_tenants=tenants,
                    spans=spans,
                )
            else:
                req.reply = wire.PlanReply(
                    found=bool(vec[1]),
                    index=int(vec[0]),
                    n_feasible=int(vec[2]),
                    # trim the bucket's K pad back to the tenant's K:
                    # slot indices beyond the tenant's own slots are pad
                    row=np.asarray(vec[3 : 3 + K], np.int32),
                    solve_ms=float(solve_ms / max(len(batch), 1)),
                    queue_wait_ms=float(waits_ms[i]),
                    batch_lanes=lanes,
                    batch_tenants=tenants,
                    spans=spans,
                )
            metrics.update_service_request("ok")
            if req.delta is not None:
                # the applied half of the delta accounting (the resync
                # half fires in note_resync — one site each)
                metrics.update_service_delta("applied")
        t_end = time.perf_counter()
        # the batch's log entry is written before any member is woken: a
        # caller holding its reply finds the batch (and its launches) in
        # the log
        self.batch_log.append({
            "popped": split["t0"],  # host clock (perf_counter)
            "queued": queued,  # requests waiting when the batch was cut
            "cap": cap,
            "tenants": [r.tenant for r in batch],
            "lanes": lanes,  # the batch's valid lanes (DRR cost)
            "horizon": batch[0].horizon,
            "queue_wait_ms": waits_ms,
            "assemble_ms": (split["t_solve"] - split["t0"]) * 1e3,
            "scatter_ms": split.get("scatter_ms", 0.0),
            "upload_ms": split.get("upload_ms", 0.0),
            "solve_ms": split.get("solve_ms", 0.0),
            "fetch_ms": split.get("fetch_ms", 0.0),
            "reply_ms": (t_end - split["t_replies"]) * 1e3,
            "path": split.get("path", "device"),
            "launches": {
                k: LAUNCHES[k] - launches[k] for k in LAUNCHES
                if LAUNCHES[k] != launches[k]
            },
        })
        for req in batch:
            req.event.set()
        if self._state_path() and (
            self._last_state_save is None
            or wall - self._last_state_save >= STATE_SAVE_INTERVAL_S
        ):
            # opportunistic warm-state save: a kill -9 at most loses one
            # interval of fingerprints, never availability
            self._last_state_save = wall
            self.save_state()
        return True

    # ------------------------------------------------------------------
    # batch assembly (full packs + delta scatter)

    @staticmethod
    def _apply_delta_host(host: PackedCluster, delta) -> None:
        """Scatter one wire delta into a cached host mirror IN PLACE —
        the same update models/columnar.apply_packed_delta defines,
        sliced to the delta's own slab width (the cached state is
        bucket-padded; columns past the agent's K are zeros on both
        sides by the pad invariant, so the narrower write is exact)."""
        k = delta.lane_slot_req.shape[1]
        host.slot_req[delta.lanes, :k] = delta.lane_slot_req
        host.slot_valid[delta.lanes, :k] = delta.lane_slot_valid
        host.slot_tol[delta.lanes, :k] = delta.lane_slot_tol
        host.slot_aff[delta.lanes, :k] = delta.lane_slot_aff
        host.cand_valid[delta.cand_rows] = delta.cand_valid
        host.spot_free[delta.spot_rows] = delta.spot_free
        host.spot_count[delta.spot_rows] = delta.spot_count
        host.spot_max_pods[delta.spot_rows] = delta.spot_max_pods
        host.spot_taints[delta.spot_rows] = delta.spot_taints
        host.spot_ok[delta.spot_rows] = delta.spot_ok
        host.spot_aff[delta.spot_rows] = delta.spot_aff

    def _assemble_batch(self, batch, bucket: Bucket, split=None):
        """Resolve a popped batch to its solve-input state: full packs
        pad into the bucket (and seed the tenant cache when they carry
        a v4 fingerprint); delta requests re-verify against the cache —
        the authoritative check, an earlier queued delta may have
        advanced it since submit — update the host mirror in place,
        and on the device path ride ONE batched scatter on the card
        (parallel/tenant_batch.apply_tenant_deltas) applying every
        tenant's churn before the batch solve; each tenant's slice of
        the result becomes its device-resident state. A delta the cache
        cannot honor (or whose apply raises) is answered with a typed
        resync demand and dropped — never a wrong plan. Returns
        (live_batch, stacked_states): numpy on the host path, tensors on
        the service's device after a scatter. ``split`` gets the
        scatter's milliseconds."""
        from k8s_spot_rescheduler_tpu_torch.models.delta import (
            empty_packed_delta,
            pad_packed_delta,
            pad_pow2,
        )

        wd = self._devhealth
        any_delta = any(r.delta is not None for r in batch)
        use_device = (
            any_delta
            and self.config.solver != "numpy"
            and batch[0].horizon == 0
            and (wd is None or not wd.sick or not self._host_path_open())
        )
        live: List[_Request] = []
        states: List[PackedCluster] = []
        deltas: List[Optional[object]] = []
        resynced: List[_Request] = []
        wall = self.clock.wall()
        with self._work:
            for req in batch:
                if req.delta is None:
                    padded = bucketing.pad_to_bucket(req.packed, bucket)
                    if req.fingerprint:
                        # owned writable copies: decoded wire tensors
                        # are read-only views into the request body,
                        # and future deltas scatter into these in place
                        host = PackedCluster(
                            *(np.array(f) for f in padded)
                        )
                        self._tenant_cache[req.tenant] = _TenantEntry(
                            req.fingerprint, host, bucket, req.K,
                            req.lanes, wall,
                        )
                        states.append(host)
                    else:
                        states.append(padded)
                    deltas.append(None)
                    live.append(req)
                    continue
                entry = self._tenant_cache.get(req.tenant)
                cause = self._cache_mismatch_locked(
                    req.tenant, entry, req.base_fp
                )
                if cause is None and entry.bucket != bucket:
                    # a stale queued delta racing a full repack into
                    # another shape family — resync, never mis-scatter
                    cause = "cached state moved to another shape bucket"
                if cause is None:
                    cause = self._validate_delta(req.delta, bucket)
                if cause is None:
                    # base for the device scatter, captured before the
                    # host mirror mutates. When it IS the host mirror
                    # (no device twin yet) the stack below may read the
                    # post-apply arrays — harmless: the scatter is a
                    # pure SET, so re-applying the same delta is
                    # idempotent bit-for-bit.
                    base = (
                        entry.device
                        if entry.device is not None
                        else entry.host
                    )
                    try:
                        self._apply_delta_host(entry.host, req.delta)
                    except Exception as err:  # noqa: BLE001, exception-discipline — ANY apply anomaly demands a typed resync (counted + flight-evented below); the entry is dropped so a partial scatter can never serve a later delta
                        self._tenant_cache.pop(req.tenant, None)
                        cause = f"delta apply failed: {err}"
                if cause is not None:
                    req.resync = cause
                    resynced.append(req)
                    continue
                entry.fp = req.new_fp
                entry.lanes = req.lanes
                entry.last_used = wall
                if not use_device:
                    # the twin was NOT part of this apply (host-only
                    # path: sick watchdog off the card, or a
                    # schedule/numpy batch):
                    # drop it, or a post-recovery device scatter would
                    # build on a base missing this batch's churn
                    entry.device = None
                states.append(base if use_device else entry.host)
                deltas.append(req.delta)
                live.append(req)
            metrics.update_service_tenant_cache(len(self._tenant_cache))
            stacked = None
            if live and not use_device:
                # host path: the mirrors already hold the post-delta
                # state; stack INSIDE the lock so no concurrent batch's
                # apply can slip between mirror and copy
                stacked = bucketing.stack_bucket(states, bucket)
        for req in resynced:
            self.note_resync(req.tenant, req.resync, req.trace_id)
            req.event.set()
        if not live:
            return [], None
        if not use_device:
            return live, stacked
        t_scatter = time.perf_counter()
        try:
            with self._on_card():
                stacked_base = PackedCluster(*(
                    torch.stack([self._device_field(s, f) for s in states])
                    for f in PackedCluster._fields
                ))
                rows = {
                    sec: pad_pow2(max(
                        (
                            len(getattr(d, sec))
                            for d in deltas
                            if d is not None
                        ),
                        default=0,
                    ))
                    for sec in ("lanes", "cand_rows", "spot_rows")
                }
                padded_deltas = [
                    pad_packed_delta(
                        d if d is not None else empty_packed_delta(states[i]),
                        bucket.C,
                        bucket.S,
                        lane_rows=rows["lanes"],
                        cand_rows=rows["cand_rows"],
                        spot_rows=rows["spot_rows"],
                        K=bucket.K,
                    )
                    for i, d in enumerate(deltas)
                ]
                delta_t = type(padded_deltas[0])
                stacked_delta = delta_t(
                    *(
                        np.stack([getattr(d, f) for d in padded_deltas])
                        for f in delta_t._fields
                    )
                )
                out_state = apply_tenant_deltas(*stacked_base, stacked_delta)
                twins = [
                    PackedCluster(*(f[i].clone() for f in out_state))
                    for i in range(len(live))
                ]
            with self._work:
                for i, req in enumerate(live):
                    entry = self._tenant_cache.get(req.tenant)
                    if entry is not None and entry.bucket == bucket:
                        # the device-resident per-tenant state: the next
                        # batch stacks these on the card
                        entry.device = twins[i]
            if split is not None:
                split["scatter_ms"] = (time.perf_counter() - t_scatter) * 1e3
            return live, out_state
        except Exception as err:  # noqa: BLE001, exception-discipline — a device-side scatter failure is contained to the HOST path (the post-apply host mirrors are authoritative and bit-identical); the device twins are dropped and rebuilt by the next batch
            log.error(
                "batched delta scatter failed on device (%s); serving "
                "this batch from the host mirrors", err,
            )
            with self._work:
                host_states = []
                for i, req in enumerate(live):
                    entry = self._tenant_cache.get(req.tenant)
                    if entry is not None:
                        entry.device = None
                    if req.delta is not None and entry is not None:
                        host_states.append(entry.host)
                    else:
                        host_states.append(states[i])
                stacked = bucketing.stack_bucket(host_states, bucket)
            return live, stacked

    # ------------------------------------------------------------------
    # device health + solve routing

    def _watchdog(self) -> Optional[DeviceHealthWatchdog]:
        if self.config.device_sick_threshold <= 0:
            return None
        with self._work:
            # lazy-create under the lock: a /healthz probe racing the
            # first batch must not replace the instance the solve path
            # just flipped sick (the gauge/flight/healthz agreement
            # depends on there being exactly ONE watchdog)
            if self._devhealth is None:
                self._devhealth = DeviceHealthWatchdog(
                    self.clock, self.config.device_sick_threshold
                )
            return self._devhealth

    def _first_compile(self, stacked: PackedCluster) -> bool:
        """True exactly once per stacked shape family: that solve pays
        the launch set-up, which the watchdog must not read as latency."""
        key = (
            stacked.slot_req.shape, stacked.spot_free.shape,
            stacked.spot_taints.shape, stacked.spot_aff.shape,
        )
        if key in self._timed_shapes:
            return False
        if len(self._timed_shapes) > 4096:
            self._timed_shapes.clear()
        self._timed_shapes.add(key)
        return True

    def _note_bucket_compile(
        self, stacked: PackedCluster, horizon: int, count: bool = True
    ) -> bool:
        """Shape-family accounting (the JAX package's compile-sharing
        counters): True exactly once per stacked shape family + schedule
        horizon (that solve sets up its launch shapes); with ``count``
        the hit/miss counters fire (warm_start marks its pre-run shapes
        seen WITHOUT counting)."""
        key = (
            stacked.slot_req.shape, stacked.spot_free.shape,
            stacked.spot_taints.shape, stacked.spot_aff.shape,
            int(horizon),
        )
        first = key not in self._compile_seen
        if first:
            if len(self._compile_seen) > 4096:
                self._compile_seen.clear()
            self._compile_seen.add(key)
        if count:
            metrics.update_service_bucket_compile(first)
        return first

    def _device_solve_timed(self, stacked: PackedCluster, batch, split=None):
        """One device-path solve (the solve_hook seam included), timed
        on the service clock, with the server-side chaos hook inside the
        timing window (injected sick-phase latency must be SEEN)."""
        t = self.clock.now()
        try:
            if self.chaos is not None:
                self.chaos.on_batch()
            if self.solve_hook is not None:
                out = np.asarray(self.solve_hook(stacked, batch))
            else:
                out = self._solve(stacked, split)
            return np.asarray(out), self.clock.now() - t, None
        except Exception as err:  # noqa: BLE001, exception-discipline — the error is RETURNED for classification: every caller either re-raises it or flips the watchdog, which fires the device-sick metric + flight event
            return None, self.clock.now() - t, err

    def _note_device_edge(self, edge: Optional[str]) -> None:
        """Fire the gauge, the flight event and the log line for one
        watchdog edge — ONE site per edge so /healthz, the
        ``service_device_sick`` gauge and the flight recorder always
        agree."""
        if edge is None:
            return
        wd = self._devhealth
        if edge == "sick":
            metrics.update_service_device_sick(True)
            flight.note_event(
                "device-sick",
                cause=wd.sick_reason or "device health watchdog fired",
            )
            log.error(
                "device sick (%s) — %s until hysteresis probes pass",
                wd.sick_reason,
                "serving the numpy-oracle host path"
                if self._host_path_open()
                else "reported only, the card keeps serving",
            )
        elif edge == "recovered":
            metrics.update_service_device_sick(False)
            flight.note_event(
                "device-recovered",
                cause=f"{wd.RECOVERY_PROBES} consecutive healthy probes",
            )
            log.info(
                "device recovered after hysteresis probes; the device "
                "solve path resumes"
            )

    def _host_path_open(self) -> bool:
        """Whether the numpy-oracle host path may answer batches while
        the watchdog holds the device sick: only off the card. A cuda
        service never moves a batch to the CPU; its watchdog reports."""
        return self.device.type != "cuda"

    def _solve_batch(self, stacked: PackedCluster, batch,
                     split=None) -> np.ndarray:
        """Route one stacked batch through the failure-domain ladder:
        the device path while healthy (timed into the watchdog). While
        sick, off the card, the numpy-oracle host path answers except
        for hysteresis probes; on the card every batch is a probe on
        the device path. A device exception flips the watchdog (or
        fails its probe) and fails the batch typed. A fault of the
        card's kernels (``is_device_fault``) flips nothing: it
        propagates, and drain_once ends the service. Host-path
        exceptions propagate to drain_once's per-batch containment."""
        self._note_bucket_compile(
            stacked, batch[0].horizon if batch else 0
        )
        if batch and batch[0].horizon > 0:
            return self._solve_schedule_batch(
                stacked, batch[0].horizon, split
            )
        wd = self._watchdog()
        if wd is None:
            out, _dur, err = self._device_solve_timed(stacked, batch, split)
            if err is not None:
                raise err
            return out
        probe = wd.sick
        if probe and self._host_path_open() and not wd.should_probe():
            return self._solve_host(stacked, split)
        first = self._first_compile(stacked)
        out, dur, err = self._device_solve_timed(stacked, batch, split)
        if err is not None and is_device_fault(err):
            raise err
        if err is not None:
            if not probe:
                self._note_device_edge(wd.note_error(err))
                # the batch still fails typed (drain_once contains it):
                # the agents' local fallback owns THIS tick — no
                # silently-different result from the batch that
                # exposed the error
                raise err
            self._note_device_edge(wd.note_probe(dur, ok=False))
            if self._host_path_open():
                return self._solve_host(stacked, split)
            raise err
        if not first:
            # a shape's first solve carries its set-up: neither a
            # slowness verdict nor a baseline sample
            self._note_device_edge(
                wd.note_probe(dur, ok=True) if probe else wd.note_batch(dur)
            )
        # a slow result is still a correct result
        return out

    def _solve_schedule_batch(self, stacked: PackedCluster, horizon: int,
                              split=None):
        """One batched drain-SCHEDULE solve (wire v3): int32
        [T, horizon, 3+K]. Routed like the single-plan solve — host
        oracle for solver=numpy and, off the card, while the watchdog
        holds the device sick — but deliberately NOT fed into the
        watchdog's latency baseline: a schedule is ~horizon single
        solves by construction, and sampling it would poison the EMA a
        single-plan batch is judged against (a device ERROR still flips the watchdog; a fault
        of the card's kernels propagates and ends the service)."""
        wd = self._watchdog()
        if self.config.solver == "numpy" or (
            wd is not None and wd.sick and self._host_path_open()
        ):
            return self._solve_schedule_host(stacked, horizon, split)
        if horizon not in self._sched_programs:
            cfg = self.config
            self._sched_programs[horizon] = make_tenant_schedule_planner(
                self._ensure_mesh(),
                horizon=horizon,
                rounds=(cfg.repair_rounds if cfg.fallback_best_fit else 0),
                best_fit_fallback=cfg.fallback_best_fit,
            )
        try:
            if self.chaos is not None:
                self.chaos.on_batch()
            # the schedule batch splits over the tenant mesh like the
            # single-plan batch: pad T to a multiple, trim after
            T = stacked.slot_req.shape[0]
            return self._run_on_card(
                self._sched_programs[horizon],
                self._pad_tenant_axis(stacked), split,
            )[:T]
        except Exception as err:  # noqa: BLE001, exception-discipline — a device failure on the schedule program flips the SAME watchdog edge (gauge + flight) as a single-plan batch, then drain_once's per-batch containment answers the tenants typed
            if wd is not None and not is_device_fault(err):
                self._note_device_edge(wd.note_error(err))
            raise

    def _solve_schedule_host(
        self, stacked: PackedCluster, horizon: int, split=None
    ) -> np.ndarray:
        """Per-tenant host drain schedules via the SAME oracle loop the
        planner's numpy branch runs (solver/schedule.
        plan_schedule_oracle) — one host implementation, no drift."""
        from k8s_spot_rescheduler_tpu_torch.solver.schedule import (
            plan_schedule_oracle,
        )

        t0 = time.perf_counter()
        cfg = self.config
        stacked = self._host_stack(stacked)
        T = stacked.slot_req.shape[0]
        K = stacked.slot_req.shape[2]
        out = np.full((T, horizon, 3 + K), -1, np.int32)
        for t in range(T):
            packed = PackedCluster(
                *(np.asarray(getattr(stacked, f)[t]) for f in stacked._fields)
            )
            out[t] = plan_schedule_oracle(
                packed,
                horizon,
                best_fit_fallback=cfg.fallback_best_fit,
                repair_rounds=cfg.repair_rounds,
            )
        if split is not None:
            split["path"] = "host"
            split["solve_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    def run_canary(self) -> None:
        """Idle liveness canary (called from the scheduler loop): a tiny
        all-invalid solve through the device path, timed into the
        watchdog, so a wedging device is noticed before the next real
        request pays for the discovery. A fault of the card's kernels
        ends the service (``ServiceFault``)."""
        wd = self._watchdog()
        if wd is None or not wd.should_canary():
            return
        bucket = self._canary_bucket()
        if bucket is None:
            return  # nothing has solved yet: no R/W/A dims to build with
        stacked = self._all_invalid_stack(bucket)
        first = self._first_compile(stacked)
        out, dur, err = self._device_solve_timed(stacked, [])
        if err is not None and is_device_fault(err):
            self._fail(err)
            raise ServiceFault(str(err)) from err
        if err is None and first:
            # the canary shape's first run pays its own set-up — a
            # liveness proof, not a latency sample
            return
        self._note_device_edge(wd.note_canary(dur, ok=err is None))

    def _canary_bucket(self) -> Optional[Bucket]:
        """The smallest bucket in the fleet's R/W/A shape family — tiny
        by construction, so the canary costs one small set-up and a
        trivial solve."""
        with self._work:
            if not self._seen_buckets:
                return None
            dims = max(self._seen_buckets, key=self._seen_buckets.get)
        b = Bucket(*dims)
        return Bucket(
            C=bucketing.MIN_DIM, K=bucketing.MIN_DIM, S=bucketing.MIN_DIM,
            R=b.R, W=b.W, A=b.A,
        )

    @staticmethod
    def _all_invalid_stack(b: Bucket) -> PackedCluster:
        """A T=1 stacked problem of pure pad at the bucket's shape:
        invalid lanes, empty slots, not-ok zero-capacity spots — solves
        to found=False rows through the real program."""
        p = PackedCluster(
            slot_req=np.zeros((b.C, b.K, b.R), np.float32),
            slot_valid=np.zeros((b.C, b.K), bool),
            slot_tol=np.zeros((b.C, b.K, b.W), np.uint32),
            slot_aff=np.zeros((b.C, b.K, b.A), np.uint32),
            cand_valid=np.zeros(b.C, bool),
            spot_free=np.zeros((b.S, b.R), np.float32),
            spot_count=np.zeros(b.S, np.int32),
            spot_max_pods=np.zeros(b.S, np.int32),
            spot_taints=np.zeros((b.S, b.W), np.uint32),
            spot_ok=np.zeros(b.S, bool),
            spot_aff=np.zeros((b.S, b.A), np.uint32),
        )
        return bucketing.stack_bucket([p], b)

    # ------------------------------------------------------------------
    # graceful drain + warm restart

    @property
    def draining(self) -> bool:
        return self._draining

    def drain_retry_after(self) -> int:
        """The ONE Retry-After horizon every drain-refusal surface
        quotes (typed ServiceBusy, HTTP header, log line): the grace —
        by then this replica is gone and another answers."""
        return max(1, int(math.ceil(self.config.service_drain_grace)))

    def begin_drain(self) -> None:
        """Stop admitting (new submissions get 503 + Retry-After); the
        already-queued work still solves, bounded by
        ``drain_pending``."""
        with self._work:
            if self._draining:
                return
            self._draining = True
            self._work.notify_all()
        log.info(
            "planner service draining: refusing new plan requests "
            "(Retry-After %ds); finishing queued batches",
            self.drain_retry_after(),
        )

    def drain_pending(self) -> None:
        """Finish queued batches within ``service_drain_grace``; evict
        whatever remains past the grace with a typed 503 so no agent
        blocks on a dying replica."""
        grace = self.config.service_drain_grace
        deadline = self.clock.now() + grace
        while self.clock.now() < deadline:
            if not self.drain_once():
                break
        with self._work:
            leftover = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
        for req in leftover:
            req.error = ServiceBusy(
                "service draining (graceful shutdown); retry another "
                "replica",
                self.drain_retry_after(),
            )
            metrics.update_service_request("expired")
            metrics.update_service_tenant_eviction(req.tenant)
            self._note_shed(
                "drain-evict",
                "queued plan request evicted by graceful drain",
                tenant=req.tenant, trace_id=req.trace_id,
            )
            req.event.set()

    def _state_path(self) -> str:
        d = self.config.service_state_dir
        return os.path.join(d, STATE_FILE) if d else ""

    def save_state(self) -> Optional[str]:
        """Persist the warm-restart state (atomic rename): per-tenant
        last-pack bucket fingerprints + the recently-used bucket list a
        restarted replica pre-warms."""
        path = self._state_path()
        if not path:
            return None
        with self._work:
            buckets = sorted(
                self._seen_buckets,
                key=self._seen_buckets.get,
                reverse=True,
            )
            payload = {
                "version": 2,
                "tenants": dict(self._tenant_bucket),
                "buckets": [list(dims) for dims in buckets],
                # delta-wire pack fingerprints: the cached CONTENT does
                # not survive a restart, but the fingerprints do — a
                # reconnecting agent's first delta then gets a resync
                # demand that NAMES the restart as its cause, and the
                # anti-entropy accounting stays exact
                "fingerprints": {
                    t: e.fp for t, e in self._tenant_cache.items()
                },
            }
        try:
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(payload, f, sort_keys=True)
            os.replace(tmp, path)
            return path
        except OSError as err:
            # a full/readonly state volume must not take the service
            # down; the only cost is a colder next restart
            log.error("planner warm-state save failed: %s", err)
            return None

    def prepare(self) -> None:
        """Build and load the kernel library on a CUDA service, before
        it takes requests: the first batch must not wait on ``nvcc``
        past its agents' deadlines. A failure is a fault of the card's
        kernels and raises (``ops/ffd_kernels.KernelError``)."""
        if self.device.type == "cuda":
            from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import library

            library()

    def warm_start(self) -> List[str]:
        """Build the kernels (``prepare``), then run the persisted
        buckets once on boot, so a restarted replica sets up their
        launch shapes before N reconnecting agents arrive; returns the
        warmed bucket keys. Reads the JAX package's warm-state file
        format."""
        self.prepare()
        path = self._state_path()
        if not path or not os.path.exists(path):
            return []
        try:
            with open(path) as f:
                payload = json.load(f)
            bucket_dims = list(payload.get("buckets", ()))
            tenants = payload.get("tenants", {})
            fingerprints = payload.get("fingerprints", {})
        except (OSError, ValueError, TypeError, AttributeError) as err:
            # valid JSON of the wrong SHAPE (a list, "buckets": 5) must
            # cost a cold start, never the boot — same contract as an
            # unreadable file
            log.error("planner warm state unreadable (%s); cold start", err)
            return []
        warmed: List[str] = []
        wall = self.clock.wall()
        for dims in bucket_dims[:WARM_MAX_BUCKETS]:
            try:
                b = Bucket(*(int(d) for d in dims))
            except (TypeError, ValueError):
                continue
            try:
                stacked = self._all_invalid_stack(b)
                self._solve(stacked)
                self._note_bucket_compile(stacked, 0, count=False)
            except Exception as err:  # noqa: BLE001, exception-discipline — a failed pre-warm costs one later cold start, never availability; boot continues and the failure is logged, except a fault of the card's kernels, which ends the boot
                if is_device_fault(err):
                    raise
                log.error("bucket %s pre-warm failed: %s", b.key, err)
                continue
            warmed.append(b.key)
            with self._work:
                self._seen_buckets[tuple(b)] = wall
        if isinstance(tenants, dict):
            with self._work:
                self._tenant_bucket.update(
                    {str(t): str(k) for t, k in tenants.items()}
                )
        if isinstance(fingerprints, dict):
            with self._work:
                self._warm_fps.update(
                    {str(t): str(fp) for t, fp in fingerprints.items()}
                )
        if warmed:
            log.info(
                "warm restart: pre-warmed %d bucket compile(s): %s",
                len(warmed), ", ".join(warmed),
            )
        self.warmed_buckets = warmed
        return warmed

    # ------------------------------------------------------------------
    # solving

    def batch_program(self) -> str:
        """What actually solves batches (surfaced on /healthz so a
        configured solver name can never silently misreport)."""
        if self.config.solver == "numpy":
            return "numpy-oracle"
        mesh = self._ensure_mesh()
        over = f", tenant mesh of {mesh.devices.size}" if mesh else ""
        if self.device.type == "cuda":
            return f"tenant-batch(torch union, B1t/B2t{over})"
        return f"tenant-batch(torch union, plain B1t/B2t on cpu{over})"

    def _ensure_mesh(self):
        """The tenant mesh over the service's ``devices``, built once:
        None with one device (the batch then solves on ``device``),
        shared by the batch and schedule programs."""
        if not self._mesh_ready:
            if len(self.devices) > 1:
                self._mesh = make_tenant_mesh(self.devices)
            self._mesh_ready = True
        return self._mesh

    def _pad_tenant_axis(self, stacked: PackedCluster) -> PackedCluster:
        """Pad the tenant axis to a multiple of the mesh size, so the
        batch splits into one block a device; pad tenants are all-zero
        problems with no valid lane (found=False rows), sliced off by
        the callers before any row reaches a reply."""
        mesh = self._ensure_mesh()
        if mesh is None:
            return stacked
        T = stacked.slot_req.shape[0]
        pad = (-T) % int(mesh.devices.size)
        if not pad:
            return stacked
        if isinstance(stacked.slot_req, torch.Tensor):
            return PackedCluster(*(
                torch.cat([f, f.new_zeros((pad,) + tuple(f.shape[1:]))])
                for f in stacked
            ))
        return PackedCluster(*(
            np.concatenate([np.asarray(f),
                            np.zeros((pad,) + f.shape[1:], f.dtype)])
            for f in stacked
        ))

    def _on_card(self):
        """The service's CUDA device as the current one (a no-op on the
        CPU), for solves on whatever thread drains."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _device_field(self, state: PackedCluster, field: str):
        """``field`` of one tenant's state on the service's device: a
        device twin's tensor as it is, a host array copied up."""
        arr = getattr(state, field)
        if isinstance(arr, torch.Tensor):
            return arr
        return torch.from_numpy(host_array(field, arr)).to(self.device)

    @staticmethod
    def _host_stack(stacked: PackedCluster) -> PackedCluster:
        """A stacked batch in host form (numpy, uint32 words)."""
        if isinstance(stacked.slot_req, torch.Tensor):
            return to_numpy(stacked)
        return stacked

    def _run_on_card(self, program, stacked: PackedCluster,
                     split=None) -> np.ndarray:
        """``program`` on the stacked batch on the service's device
        (uploaded first when it is host arrays), fetched once; ``split``
        gets the upload, solve and fetch milliseconds."""
        t0 = time.perf_counter()
        with self._on_card():
            if not isinstance(stacked.slot_req, torch.Tensor):
                stacked = PackedCluster(*(
                    self._device_field(stacked, f)
                    for f in PackedCluster._fields
                ))
            t1 = time.perf_counter()
            out = program(stacked)
            t2 = time.perf_counter()
            host = out.cpu().numpy()  # the ONE fetch of the batch
        if split is not None:
            t3 = time.perf_counter()
            split["upload_ms"] = (t1 - t0) * 1e3
            split["solve_ms"] = (t2 - t1) * 1e3
            split["fetch_ms"] = (t3 - t2) * 1e3
        return host

    def _solve(self, stacked: PackedCluster, split=None) -> np.ndarray:
        if self.config.solver == "numpy":
            return self._solve_host(stacked, split)
        if self._batched is None:
            cfg = self.config
            self._batched = make_tenant_batch_planner(
                self._ensure_mesh(),
                rounds=(
                    cfg.repair_rounds if cfg.fallback_best_fit else 0
                ),
                best_fit_fallback=cfg.fallback_best_fit,
            )
        T = stacked.slot_req.shape[0]
        return self._run_on_card(
            self._batched, self._pad_tenant_axis(stacked), split)[:T]

    def _solve_host(self, stacked: PackedCluster, split=None) -> np.ndarray:
        """The numpy-oracle batch path (--solver numpy, and off the card
        while the watchdog holds the device sick): the SAME union helper
        the planner's host branch calls (solver/numpy_oracle.
        plan_union_oracle), per tenant — one host union, so the two
        paths cannot drift."""
        from k8s_spot_rescheduler_tpu_torch.solver.numpy_oracle import (
            plan_union_oracle,
        )

        t0 = time.perf_counter()
        cfg = self.config
        stacked = self._host_stack(stacked)
        T = stacked.slot_req.shape[0]
        K = stacked.slot_req.shape[2]
        out = np.zeros((T, 3 + K), np.int32)
        for t in range(T):
            packed = PackedCluster(
                *(np.asarray(getattr(stacked, f)[t]) for f in stacked._fields)
            )
            result = plan_union_oracle(
                packed,
                best_fit_fallback=cfg.fallback_best_fit,
                repair_rounds=cfg.repair_rounds,
            )
            feasible = np.asarray(result.feasible)
            idx = int(np.argmax(feasible)) if feasible.size else 0
            out[t, 0] = idx
            out[t, 1] = int(bool(feasible.any()))
            out[t, 2] = int(feasible.sum())
            if feasible.size:
                out[t, 3:] = np.asarray(result.assignment[idx], np.int32)
        if split is not None:
            split["path"] = "host"
            split["solve_ms"] = (time.perf_counter() - t0) * 1e3
        return out

    # ------------------------------------------------------------------
    # scheduler thread

    def start_scheduler(self) -> None:
        if self._thread is not None:
            return
        with self._work:
            self._stop = False
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def stop_scheduler(self) -> None:
        with self._work:
            self._stop = True
            self._work.notify_all()
        if self._thread is not None:
            if self._thread is not threading.current_thread():
                self._thread.join(timeout=5)
            self._thread = None

    def _fail(self, err: BaseException) -> None:
        """A fault of the card's kernels: record it, stop taking work,
        answer every queued request typed, and tell ``on_fatal``."""
        with self._work:
            if self.fatal is not None:
                return
            self.fatal = err
            self._stop = True
            leftover = [r for q in self._queues.values() for r in q]
            for q in self._queues.values():
                q.clear()
            self._work.notify_all()
        log.error(
            "a fault of the card's kernels ended the planner service: %s",
            err,
        )
        flight.note_event("service-fault", cause=str(err))
        for req in leftover:
            req.error = ServiceBusy(f"service ended: {err}", 0)
            metrics.update_service_request("error")
            req.event.set()
        for callback in list(self.on_fatal):
            callback()

    def _loop(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        try:
            self._schedule()
        except ServiceFault:
            return  # self.fatal holds the cause; on_fatal was told

    def _schedule(self) -> None:
        while True:
            with self._work:
                has_work = any(self._queues.get(t) for t in self._queues)
                if not has_work and not self._stop and not self._draining:
                    self._work.wait(timeout=1.0)
                    has_work = any(
                        self._queues.get(t) for t in self._queues
                    )
                if self._stop:
                    return
                if self._draining and not has_work:
                    # graceful drain finished its queue; drain_pending
                    # owns the bounded tail, nothing left to schedule
                    return
            if not has_work:
                # idle: give the device-health watchdog its canary
                # window (no-op unless overdue)
                self.run_canary()
                continue
            # coalescing window: concurrent tenants land in one batch
            # (skipped while draining — latency no longer buys batching)
            if self.batch_window_s > 0 and not self._draining:
                self.clock.sleep(self.batch_window_s)
            while self.drain_once():
                pass


# ---------------------------------------------------------------------------
# HTTP surface


class _FleetHTTPServer(ThreadingHTTPServer):
    """The service's HTTP server with a listen backlog for a fleet: at
    socketserver's default of 5, agents that connect at once overflow
    it, and each dropped SYN waits out TCP's 1 s retransmission, past
    the batch window its peers ride."""

    request_queue_size = 128


class ServiceServer:
    """HTTP front of a :class:`PlannerService`: ``/v2/plan`` (binary
    wire), ``/v1/plan`` (legacy JSON adapter over the same queue) and
    ``/healthz``. Edge bounds are the sidecar's, unchanged: body cap
    (413), handler depth cap with pre-body-read rejection (503)."""

    def __init__(
        self,
        config: ReschedulerConfig,
        address: str = "127.0.0.1:8642",
        *,
        max_body_bytes: int = 128 << 20,
        queue_timeout_s: Optional[float] = None,
        # fleet-facing default: comfortably above the HBM-derived batch
        # caps so concurrently-ticking agents are queued (and batched),
        # not shed; the single-tenant sidecar surface keeps its
        # historical 4
        max_inflight: int = 16,
        batch_window_s: Optional[float] = None,
        max_batch_tenants: int = 0,
        clock: Optional[Clock] = None,
        device=None,
        devices=None,
    ):
        self.config = config
        self.service = PlannerService(
            config,
            queue_timeout_s=queue_timeout_s,
            batch_window_s=batch_window_s,
            max_batch_tenants=max_batch_tenants,
            clock=clock,
            device=device,
            devices=devices,
        )
        # the kernels are built and loaded before the socket listens
        self.service.prepare()
        self.service.on_fatal.append(self._stop_serving)
        self.max_body_bytes = int(max_body_bytes)
        self.max_inflight = int(max_inflight)
        self._inflight = 0
        self._inflight_lock = threading.Lock()
        # Resync-storm admission class (docs/ROBUSTNESS.md "Resync
        # storms"): full-pack resync ingests — a fingerprinted full
        # pack from a tenant with NO cached state (first contact or
        # post-restart re-seed) — get their own bounded admission:
        # a concurrent-ingest token bucket plus a byte ledger charging
        # each ingest its estimated per-tenant HBM footprint (the same
        # model the batch cap uses). A replica restart under a large
        # fleet stales every tenant's fingerprint at once; this class
        # sheds the excess (503 + load-derived Retry-After, reason
        # resync-storm) so delta traffic and cached tenants keep their
        # queue-wait SLO instead of the queue collapsing.
        self.resync_ingest_cap = int(config.service_resync_ingest_cap)
        self._resync_lock = threading.Lock()
        self._resync_inflight = 0
        self._resync_ledger_bytes = 0
        # refusals not yet drained by a completed ingest — the load
        # term that makes Retry-After grow with the storm instead of
        # answering every refused tenant the same static horizon
        self._resync_pressure = 0
        # flight recorder knobs ride the same config the control loop
        # uses; in service-only mode this process records request-level
        # degradation events (sheds, solve failures) instead of ticks
        flight.configure(
            ring_size=config.flight_ring_size,
            dump_dir=config.flight_dump_dir,
        )
        # the last few requests' server-side span blocks, keyed by the
        # agent trace ID that sent them (/debug/trace on a service that
        # has no tick of its own)
        self._recent_lock = threading.Lock()
        self._recent: deque = deque(maxlen=32)
        # live accepted sockets: with keep-alive a handler thread stays
        # parked in readline() between requests, so closing the listener
        # alone would leave pooled agent connections happily served by a
        # "stopped" replica — close() must hard-close these too
        self._conn_lock = threading.Lock()
        self._open_conns: set = set()
        host, _, port = address.rpartition(":")
        server = self

        class Handler(BaseHTTPRequestHandler):
            # Keep-alive for the persistent agent wire (service/agent.py
            # PooledWireTransport): HTTP/1.1 + the Content-Length
            # discipline _send_bytes already enforces lets one socket
            # carry every tick. The default HTTP/1.0 answered one
            # request per connection — the per-tick TCP+HTTP setup tax
            # the pool exists to amortize. Pre-body rejects still close
            # (_reject_unread), and an idle connection is reaped after
            # ``timeout`` so drained agents don't pin handler threads.
            protocol_version = "HTTP/1.1"
            timeout = 120.0
            # on a keep-alive connection the reply goes out as two
            # writes (buffered headers, then body): with Nagle on, the
            # body segment sits behind the client's delayed ACK —
            # a ~40ms stall per tick that dwarfs the round trip the
            # pool exists to shrink. (A closing connection never showed
            # it: the FIN flushed the tail.)
            disable_nagle_algorithm = True

            def setup(self):
                super().setup()
                with server._conn_lock:
                    server._open_conns.add(self.connection)

            def finish(self):
                try:
                    super().finish()
                finally:
                    with server._conn_lock:
                        server._open_conns.discard(self.connection)

            def log_message(self, *a):
                pass

            def _send_json(self, obj, code=200, headers=()):
                data = json.dumps(obj).encode()
                self._send_bytes(data, "application/json", code, headers)

            def _send_bytes(self, data, ctype, code=200, headers=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(data)))
                for k, v in headers:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(data)

            def do_GET(self):
                if self.path == "/healthz":
                    from k8s_spot_rescheduler_tpu_torch.loop import health

                    out = {
                        "ok": server.service.fatal is None,
                        "solver": server.config.solver,
                        "solve_device": str(server.service.device),
                        "batch_program": server.service.batch_program(),
                    }
                    out.update(server.service.healthz_snapshot())
                    out.update(health.STATE.snapshot())
                    return self._send_json(out)
                if self.path.startswith("/debug/"):
                    return self._debug_get()
                return self._send_json({"error": "not found"}, 404)

            def _debug_get(self):
                """/debug/trace (last tick tree + recent server span
                blocks) and /debug/flight (ring summary; ?dump=1 writes
                a postmortem). Gated off by default: 404, not 403, so a
                disabled surface is indistinguishable from an absent
                one."""
                if not server.config.debug_endpoints:
                    return self._send_json({"error": "not found"}, 404)
                path, _, query = self.path.partition("?")
                if path == "/debug/trace":
                    return self._send_json({
                        "last_tick": flight.last_tick(),
                        "recent_requests": server.recent_request_traces(),
                    })
                if path == "/debug/flight":
                    out = flight.snapshot()
                    if "dump=1" in query.split("&"):
                        out["dumped"] = flight.dump("debug-endpoint")
                    return self._send_json(out)
                return self._send_json({"error": "not found"}, 404)

            def _reject_unread(self, obj, code, headers=()):
                """A response sent BEFORE the body was read must close
                the connection: under keep-alive the unconsumed body
                bytes would desync the next request on this socket.
                Applies to every pre-read reject — 400/404/413/503."""
                self.close_connection = True
                return self._send_json(
                    obj, code,
                    headers=tuple(headers) + (("Connection", "close"),),
                )

            def _read_body(self):
                """Content-Length checks + the body read, or None if a
                reject was already sent."""
                try:
                    length = int(self.headers.get("Content-Length", 0))
                except ValueError:
                    self._reject_unread({"error": "bad Content-Length"}, 400)
                    return None
                if length < 0:
                    # must not reach rfile.read(-1): buffer-until-EOF is
                    # the exact exhaustion the size cap prevents
                    self._reject_unread({"error": "bad Content-Length"}, 400)
                    return None
                if length > server.max_body_bytes:
                    self._reject_unread(
                        {
                            "error": "request exceeds %d-byte limit"
                            % server.max_body_bytes
                        },
                        413,
                    )
                    metrics.update_service_request("rejected")
                    return None
                if server.service.draining:
                    # graceful drain: refuse BEFORE the body is read,
                    # naming the horizon a failover replica answers by
                    metrics.update_service_request("rejected")
                    server.service._note_shed(
                        "drain-refuse",
                        "replica draining (graceful shutdown)",
                        trace_id=self.headers.get("X-Trace-Id", "") or "",
                    )
                    self._reject_unread(
                        {"error": "planner draining"},
                        503,
                        headers=[(
                            "Retry-After",
                            str(server.service.drain_retry_after()),
                        )],
                    )
                    return None
                if not server._admit():
                    metrics.update_service_request("rejected")
                    server.service._note_shed(
                        "max-inflight",
                        "planner overloaded (%d requests in flight)"
                        % server.max_inflight,
                        trace_id=self.headers.get("X-Trace-Id", "") or "",
                    )
                    self._reject_unread(
                        {
                            "error": "planner overloaded (%d requests in "
                            "flight)" % server.max_inflight
                        },
                        503,
                        headers=[(
                            "Retry-After",
                            str(server.service.retry_after()),
                        )],
                    )
                    return None
                try:
                    return self.rfile.read(length)
                except Exception:
                    # the slot was admitted above but the caller's
                    # finally-release is only reached once we RETURN a
                    # body — a client aborting mid-upload must not leak
                    # its inflight slot forever
                    server._release()
                    raise

            def do_POST(self):
                if self.path == "/v2/plan":
                    return self._post_wire()
                if self.path == "/v1/plan":
                    return self._post_json()
                return self._reject_unread({"error": "not found"}, 404)

            def _post_wire(self):
                t_req = time.perf_counter()
                body = self._read_body()
                if body is None:
                    return
                # ingest-bandwidth accounting (the ceiling the delta
                # wire lowers): every /v2/plan body, pack or delta
                metrics.update_service_wire_ingest(len(body))
                chaos = server.service.chaos
                if chaos is not None:
                    # the decode chaos hook: a corrupted request must
                    # come back as a clean typed 400, never a crash
                    corrupted = chaos.corrupt_request(body)
                    if corrupted is not None:
                        body = corrupted
                # the reply speaks the REQUEST's protocol version so an
                # un-upgraded v1 agent keeps decoding; before a
                # successful decode the raw header byte is the best
                # guess (falling back to v1, which every decoder speaks)
                raw_version = body[4] if len(body) > 4 else 0
                reply_version = (
                    raw_version
                    if raw_version in wire.SUPPORTED_VERSIONS
                    else 1
                )
                if (
                    len(body) > 5
                    and body[5] == wire.KIND_PACKED_DELTA
                    and reply_version >= 4
                ):
                    # the delta wire (v4): same endpoint, its own
                    # decode/answer contract (resync-on-anything)
                    return self._post_wire_delta(body, t_req)
                # ledger charge held by THIS request when it was
                # admitted as a resync-class ingest (-1 = not one);
                # released in the finally below
                resync_charge = -1
                try:
                    admit_ms = (time.perf_counter() - t_req) * 1e3
                    try:
                        t_dec = time.perf_counter()
                        req = wire.decode_plan_request_ex(body)
                        decode_ms = (time.perf_counter() - t_dec) * 1e3
                    except wire.WireError as err:
                        metrics.update_service_request("error")
                        return self._send_bytes(
                            wire.encode_error(
                                str(err), version=reply_version
                            ),
                            "application/octet-stream", 400,
                        )
                    trace_id = req.trace_id or (
                        self.headers.get("X-Trace-Id", "") or ""
                    )
                    # Resync-storm admission: a fingerprinted full pack
                    # for a tenant with no cached state is a
                    # cache-seeding resync ingest (first contact or the
                    # post-restart re-upload every tenant fires at
                    # once). It must clear the bounded resync class
                    # BEFORE entering the queue — delta traffic and
                    # cached tenants never touch this gate.
                    if req.pack_fingerprint and not (
                        server.service.tenant_cached(req.tenant)
                    ):
                        ok, retry, charge = server.admit_resync_ingest(
                            req.packed
                        )
                        if not ok:
                            metrics.update_service_request("rejected")
                            server.service._note_shed(
                                "resync-storm",
                                "full-pack resync ingest refused: "
                                "concurrent-ingest cap or byte ledger "
                                "exhausted",
                                tenant=req.tenant, trace_id=trace_id,
                                kind="resync-shed",
                            )
                            return self._send_bytes(
                                wire.encode_error(
                                    "resync ingest shed (storm "
                                    "admission); retry after the "
                                    "suggested horizon",
                                    version=reply_version,
                                ),
                                "application/octet-stream", 503,
                                headers=[("Retry-After", str(retry))],
                            )
                        resync_charge = charge
                    try:
                        # the agent declares its own HTTP deadline:
                        # waiting longer server-side would batch-solve
                        # (and hold an inflight slot for) a request the
                        # caller already abandoned
                        try:
                            deadline = float(
                                self.headers.get("X-Planner-Deadline", 0)
                                or 0
                            )
                        except (TypeError, ValueError):
                            deadline = 0.0
                        reply = server.service.submit(
                            req.tenant, req.packed,
                            timeout_s=deadline or None,
                            trace_id=trace_id,
                            schedule_horizon=req.schedule_horizon,
                            pack_fingerprint=req.pack_fingerprint,
                        )
                    except ServiceBusy as err:
                        return self._send_bytes(
                            wire.encode_error(
                                str(err), version=reply_version
                            ),
                            "application/octet-stream", 503,
                            headers=[("Retry-After", str(err.retry_after))],
                        )
                    # complete the server-side span block: admit (slot
                    # + body read) and decode ahead of the queue spans,
                    # encode measured on a first encode and shipped via
                    # a second (the reply is a few hundred bytes; the
                    # re-encode costs less than leaving the span out)
                    spans = (
                        tracing.make_span("service.admit", 0.0, admit_ms),
                        tracing.make_span(
                            "service.decode", admit_ms, decode_ms
                        ),
                    ) + reply.spans
                    # schedule requests (wire v3) answer in the
                    # schedule kind; the encode dance is identical
                    encode = (
                        wire.encode_plan_schedule_reply
                        if isinstance(reply, wire.PlanScheduleReply)
                        else wire.encode_plan_reply
                    )
                    t_enc = time.perf_counter()
                    encode(
                        reply._replace(spans=spans), version=req.version
                    )
                    encode_ms = (time.perf_counter() - t_enc) * 1e3
                    spans = spans + (
                        tracing.make_span("service.encode", 0.0, encode_ms),
                    )
                    server.note_request_trace(trace_id, req.tenant, spans)
                    return self._send_bytes(
                        encode(
                            reply._replace(spans=spans),
                            version=req.version,
                        ),
                        "application/octet-stream",
                    )
                except Exception as err:  # noqa: BLE001 — handler survives
                    log.error("service /v2/plan failed: %s", err)
                    metrics.update_service_request("error")
                    return self._send_bytes(
                        wire.encode_error(str(err), version=reply_version),
                        "application/octet-stream", 500,
                    )
                finally:
                    if resync_charge >= 0:
                        server.release_resync_ingest(resync_charge)
                    server._release()

            def _post_wire_delta(self, body: bytes, t_req: float):
                """One delta-backed plan request (wire v4). The answer
                ladder is resync-on-anything: a decode anomaly, an
                unknown/mismatched base, or an apply failure all come
                back as HTTP 200 + KIND_RESYNC (a 4xx would read as an
                endpoint failure and trip the agent's breaker — a
                resync is protocol, not an outage); only queue
                pressure (503) and handler bugs (500) answer as for
                full packs. The caller already released no state: the
                inflight slot is freed in the finally as usual."""
                try:
                    admit_ms = (time.perf_counter() - t_req) * 1e3
                    header_trace = self.headers.get("X-Trace-Id", "") or ""
                    try:
                        t_dec = time.perf_counter()
                        dreq = wire.decode_packed_delta_ex(body)
                        decode_ms = (time.perf_counter() - t_dec) * 1e3
                    except wire.WireError as err:
                        # ANY decode anomaly (truncation, bit flip —
                        # the digest catches payload corruption) is a
                        # typed resync demand; the agent answers with
                        # one full pack, never a wrong plan
                        cause = f"delta decode failed: {err}"
                        server.service.note_resync(
                            "", cause, header_trace
                        )
                        return self._send_bytes(
                            wire.encode_resync(cause, version=4),
                            "application/octet-stream",
                        )
                    trace_id = dreq.trace_id or header_trace
                    try:
                        deadline = float(
                            self.headers.get("X-Planner-Deadline", 0)
                            or 0
                        )
                    except (TypeError, ValueError):
                        deadline = 0.0
                    try:
                        reply = server.service.submit_delta(
                            dreq.tenant,
                            dreq.delta,
                            dreq.base_fingerprint,
                            dreq.new_fingerprint,
                            timeout_s=deadline or None,
                            trace_id=trace_id,
                        )
                    except ResyncRequired as err:
                        # counted + flight-evented at the demand site
                        return self._send_bytes(
                            wire.encode_resync(str(err), version=4),
                            "application/octet-stream",
                        )
                    except ServiceBusy as err:
                        return self._send_bytes(
                            wire.encode_error(str(err), version=4),
                            "application/octet-stream", 503,
                            headers=[("Retry-After", str(err.retry_after))],
                        )
                    spans = (
                        tracing.make_span("service.admit", 0.0, admit_ms),
                        tracing.make_span(
                            "service.decode", admit_ms, decode_ms
                        ),
                    ) + reply.spans
                    t_enc = time.perf_counter()
                    wire.encode_plan_reply(
                        reply._replace(spans=spans), version=dreq.version
                    )
                    encode_ms = (time.perf_counter() - t_enc) * 1e3
                    spans = spans + (
                        tracing.make_span("service.encode", 0.0, encode_ms),
                    )
                    server.note_request_trace(trace_id, dreq.tenant, spans)
                    return self._send_bytes(
                        wire.encode_plan_reply(
                            reply._replace(spans=spans),
                            version=dreq.version,
                        ),
                        "application/octet-stream",
                    )
                except Exception as err:  # noqa: BLE001 — handler survives
                    log.error("service /v2/plan (delta) failed: %s", err)
                    metrics.update_service_request("error")
                    return self._send_bytes(
                        wire.encode_error(str(err), version=4),
                        "application/octet-stream", 500,
                    )
                finally:
                    server._release()

            def _post_json(self):
                body = self._read_body()
                if body is None:
                    return
                try:
                    try:
                        snapshot = json.loads(body)
                    except ValueError as err:
                        return self._send_json({"error": str(err)}, 400)
                    tenant = self.headers.get("X-Tenant") or "default"
                    try:
                        result = server.plan_json(snapshot, tenant=tenant)
                    except ServiceBusy as err:
                        return self._send_json(
                            {"error": str(err)}, 503,
                            headers=[("Retry-After", str(err.retry_after))],
                        )
                    except (ValueError, KeyError) as err:
                        return self._send_json({"error": str(err)}, 400)
                    return self._send_json(result)
                except Exception as err:  # noqa: BLE001 — handler survives
                    log.error("service /v1/plan failed: %s", err)
                    metrics.update_service_request("error")
                    return self._send_json({"error": str(err)}, 500)
                finally:
                    server._release()

        self.server = _FleetHTTPServer(
            (host or "127.0.0.1", int(port)), Handler
        )

    def _admit(self) -> bool:
        with self._inflight_lock:
            if self._inflight >= self.max_inflight:
                return False
            self._inflight += 1
            return True

    def _release(self) -> None:
        with self._inflight_lock:
            self._inflight -= 1

    def _resync_ingest_budget(self) -> int:
        """Byte budget for the resync-ingest ledger: the configured
        override, else the device budget the batch cap sizes against."""
        configured = int(self.config.service_resync_ingest_budget)
        if configured > 0:
            return configured
        return int(self.config.solver_hbm_budget) or memory.device_hbm_budget(
            self.service.device)

    def admit_resync_ingest(self, packed):
        """Gate ONE cache-seeding full-pack resync ingest through the
        bounded admission class. Returns ``(admitted, retry_after_s,
        charge_bytes)``; an admitted ingest holds one token and
        ``charge_bytes`` of ledger until :meth:`release_resync_ingest`.
        Refusals carry a LOAD-derived Retry-After: the measured batch
        cadence scaled by how deep the storm currently is (in-flight
        ingests plus undrained refusals, per cap slot) — the herd is
        answered with staggered horizons, not one synchronized
        comeback time. A lone over-budget tenant is still admitted
        when the class is idle (the batch cap's never-zero floor)."""
        bucket = bucketing.bucket_for(packed)
        per = bucketing.per_tenant_hbm_bytes(bucket)
        budget = self._resync_ingest_budget()
        with self._resync_lock:
            over_cap = self._resync_inflight >= self.resync_ingest_cap
            over_budget = (
                self._resync_inflight > 0
                and self._resync_ledger_bytes + per > budget
            )
            if over_cap or over_budget:
                self._resync_pressure += 1
                cadence = max(1, self.service.retry_after())
                retry = int(math.ceil(
                    cadence
                    * (self._resync_inflight + self._resync_pressure)
                    / max(1, self.resync_ingest_cap)
                ))
                return False, max(1, retry), 0
            self._resync_inflight += 1
            self._resync_ledger_bytes += per
            metrics.update_service_resync_ingest(
                self._resync_inflight, self._resync_ledger_bytes,
                admitted=True,
            )
            return True, 0, per

    def note_request_trace(self, trace_id: str, tenant: str, spans) -> None:
        """Remember one request's server-side span block, keyed by the
        agent's trace ID (/debug/trace on the service process). The
        tenant id is client-supplied and /debug responses may leave the
        process, so it rides hashed per the redaction policy."""
        entry = {
            "trace_id": trace_id,
            "tenant": flight.redact_text(tenant),
            "spans": [
                {"name": n, "t0_ms": round(t0, 3), "dur_ms": round(d, 3)}
                for n, t0, d in spans
            ],
        }
        with self._recent_lock:
            self._recent.append(entry)

    def recent_request_traces(self) -> list:
        with self._recent_lock:
            return list(self._recent)

    def release_resync_ingest(self, charge_bytes: int) -> None:
        """Return one resync-ingest token (and its ledger bytes); each
        completed ingest also drains one unit of refusal pressure so
        Retry-After horizons relax as the storm is worked off."""
        with self._resync_lock:
            self._resync_inflight = max(0, self._resync_inflight - 1)
            self._resync_ledger_bytes = max(
                0, self._resync_ledger_bytes - int(charge_bytes)
            )
            self._resync_pressure = max(0, self._resync_pressure - 1)
            metrics.update_service_resync_ingest(
                self._resync_inflight, self._resync_ledger_bytes
            )

    @property
    def address(self) -> str:
        host, port = self.server.server_address
        return f"{host}:{port}"

    # ------------------------------------------------------------------
    # the legacy JSON adapter: decode -> pack -> the SAME queue

    def plan_json(self, body: dict, *, tenant: str = "default") -> dict:
        """Kubernetes-JSON snapshot in, legacy /v1/plan response out —
        packed host-side and solved through the batching queue exactly
        like a wire-protocol tenant (one solve path)."""
        from k8s_spot_rescheduler_tpu_torch.io.kube import (
            decode_node,
            decode_pdb,
            decode_pod,
        )
        from k8s_spot_rescheduler_tpu_torch.models.cluster import build_node_map
        from k8s_spot_rescheduler_tpu_torch.models.tensors import pack_cluster

        cfg = self.config
        nodes = [decode_node(o) for o in body.get("nodes", [])]
        pods = [decode_pod(o) for o in body.get("pods", [])]
        pdbs = [decode_pdb(o) for o in body.get("pdbs", [])]
        pvc_objs = body.get("pvcs") or []
        pv_objs = body.get("pvs") or []
        if pvc_objs or pv_objs:
            from k8s_spot_rescheduler_tpu_torch.io.kube import (
                decode_volume_snapshots,
            )
            from k8s_spot_rescheduler_tpu_torch.models.volumes import (
                resolve_volume_affinity,
            )

            pvcs, pvs = decode_volume_snapshots(pvc_objs, pv_objs)
            pods = [
                resolve_volume_affinity(p, pvcs, pvs)
                if p.pvc_resolvable
                else p
                for p in pods
            ]
        pods_by_node: dict = {}
        for pod in pods:
            pods_by_node.setdefault(pod.node_name, []).append(pod)
        node_map = build_node_map(
            [n for n in nodes if n.ready],
            pods_by_node,
            on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label,
            priority_threshold=cfg.priority_threshold,
            # not-ready nodes are presence-only (zone/spread counts) —
            # dropping them would overstate the spread domain-min, the
            # permissive direction (same rule as the control loop)
            unready_nodes=[n for n in nodes if not n.ready],
        )
        packed, meta = pack_cluster(
            node_map,
            pdbs,
            resources=cfg.resources,
            delete_non_replicated=cfg.delete_non_replicated_pods,
            pad_slots=cfg.max_pods_per_node_hint,
        )
        reply = self.service.submit(tenant, packed)
        out = {
            "found": reply.found,
            "nCandidates": meta.n_candidates,
            "nFeasible": reply.n_feasible,
            "solveMs": round(reply.solve_ms, 3),
            "batchLanes": reply.batch_lanes,
            "batchTenants": reply.batch_tenants,
        }
        if reply.found:
            plan = meta.build_plan(reply.index, np.asarray(reply.row))
            out["node"] = plan.node.node.name
            out["pods"] = [p.uid for p in plan.pods]
            out["assignments"] = plan.assignments
        return out

    # ------------------------------------------------------------------
    # lifecycle

    def serve_forever(self) -> None:
        """Serve until ``close`` (or a graceful drain); raises
        ``ServiceFault`` when a fault of the card's kernels ended the
        service."""
        log.info("planner service listening on %s", self.address)
        self.service.warm_start()
        self.service.start_scheduler()
        self._serving = True
        self.server.serve_forever()
        if self.service.fatal is not None:
            self.close()
            raise ServiceFault(str(self.service.fatal)) from self.service.fatal

    def start_background(self, scheduler: bool = True) -> None:
        """Serve on a daemon thread. ``scheduler=False`` skips the
        batching thread: submissions then drain synchronously on the
        handler thread — the deterministic mode a virtual-clock caller
        drives (no thread ever sleeps on the shared clock)."""
        self.service.warm_start()
        if scheduler:
            self.service.start_scheduler()
        self._serving = True
        threading.Thread(target=self.server.serve_forever, daemon=True).start()

    def _stop_serving(self) -> None:
        """``on_fatal``: stop the HTTP loop from another thread, so
        ``serve_forever`` returns and raises."""
        if getattr(self, "_serving", False):
            threading.Thread(target=self.server.shutdown, daemon=True).start()

    def graceful_shutdown(self) -> None:
        """The SIGTERM contract (docs/ROBUSTNESS.md): stop admitting
        (503 + Retry-After = the drain grace), finish queued batches
        within ``service_drain_grace``, persist the warm-restart state,
        then stop serving."""
        svc = self.service
        svc.begin_drain()
        svc.stop_scheduler()
        svc.drain_pending()
        self.close()  # close() persists the warm state

    def close(self) -> None:
        # shutdown() handshakes with a RUNNING serve_forever loop; with
        # no loop ever started (in-process use) it would block forever
        # on an event only serve_forever sets
        if getattr(self, "_serving", False):
            self._serving = False
            self.server.shutdown()
        self.server.server_close()
        # hard-close live keep-alive connections: their handler threads
        # are parked in readline() waiting for the agent's next request
        # and would keep answering a "closed" replica otherwise
        with self._conn_lock:
            conns = list(self._open_conns)
            self._open_conns.clear()
        for conn in conns:
            with contextlib.suppress(OSError):
                conn.shutdown(socket.SHUT_RDWR)
        self.service.stop_scheduler()
        self.service.save_state()


def main(argv=None) -> int:
    """``python -m k8s_spot_rescheduler_tpu_torch.service.server`` — the
    standalone multi-tenant planner (also reachable as ``--serve`` on
    the main CLI). Exits 1 when a fault of the card's kernels ended it."""
    import argparse

    ap = argparse.ArgumentParser(prog="spot-rescheduler-planner-service")
    ap.add_argument("--listen", default="127.0.0.1:8642")
    ap.add_argument("--solver", default="torch", choices=["torch", "numpy"])
    ap.add_argument("--device", default="cuda",
                    help="where batches solve: cuda (default) or cpu")
    ap.add_argument("--max-body-mb", type=int, default=128,
                    help="reject request bodies larger than this (413)")
    ap.add_argument("--queue-timeout", type=float, default=30.0,
                    help="seconds a plan request may wait in the tenant "
                         "queue before 503 + measured-cadence Retry-After")
    ap.add_argument("--batch-window", type=float, default=0.02,
                    help="seconds the batcher waits to coalesce "
                         "concurrent tenants into one solve")
    ap.add_argument("--max-inflight", type=int, default=16,
                    help="reject immediately (503) past this many "
                         "concurrent requests — bounds worst-case request "
                         "memory at max-inflight x max-body-mb")
    ap.add_argument("--state-dir", default="",
                    help="persist per-tenant pack fingerprints + the "
                         "bucket warmup list here (warm restart)")
    ap.add_argument("--drain-grace", type=float, default=5.0,
                    help="seconds SIGTERM lets queued batches finish "
                         "before the rest are evicted with 503")
    ap.add_argument("-v", "--verbosity", type=int, default=0)
    args = ap.parse_args(argv)
    log.setup(args.verbosity)
    server = ServiceServer(
        ReschedulerConfig(
            solver=args.solver,
            service_queue_timeout=args.queue_timeout,
            service_batch_window=args.batch_window,
            service_state_dir=args.state_dir,
            service_drain_grace=args.drain_grace,
        ),
        args.listen,
        max_body_bytes=args.max_body_mb << 20,
        max_inflight=args.max_inflight,
        device=args.device,
    )
    install_sigterm_drain(server)
    try:
        server.serve_forever()
    except ServiceFault:
        return 1
    return 0


def install_sigterm_drain(server: ServiceServer) -> bool:
    """Route SIGTERM into the graceful-drain contract (no-op outside
    the main thread — an embedded server's host process owns its own
    signals). Returns whether the handler was installed."""
    import signal

    def _sigterm(*_):
        # off the signal frame: graceful_shutdown blocks up to the
        # drain grace and must not run inside the handler
        threading.Thread(
            target=server.graceful_shutdown, daemon=True
        ).start()

    try:
        signal.signal(signal.SIGTERM, _sigterm)
        return True
    except ValueError:
        return False


if __name__ == "__main__":
    import sys

    sys.exit(main())
