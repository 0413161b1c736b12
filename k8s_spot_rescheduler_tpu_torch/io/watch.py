"""Watch-backed cluster caches — the reference's lister equivalents.

The reference never LISTs the whole cluster on its hot path: it builds
three watch-cache listers at startup (reference rescheduler.go:154-156,
``NewReadyNodeLister`` / ``NewPodDisruptionBudgetLister`` /
``NewUnschedulablePodLister``) and every per-tick read hits the local
cache that a background watch stream keeps current. ``KubeClusterClient``
(io/kube.py) approximates that with one full LIST per tick — correct, but
at north-star scale (50k pods) each tick re-transfers the entire pod set.

This module is the faithful equivalent: per-resource background watchers
following the standard Kubernetes list-then-watch protocol —

1. LIST to seed the store and learn ``metadata.resourceVersion``;
2. WATCH from that version with ``allowWatchBookmarks`` — apply
   ADDED/MODIFIED/DELETED incrementally, advance the version on BOOKMARK;
3. on 410 Gone (version expired from etcd) or any stream error, re-LIST
   and resume — the store is level-triggered, never wedged.

``WatchingKubeClusterClient`` serves the ``ClusterClient`` read path from
these stores. Each housekeeping tick gets one *consistent snapshot*: the
first read of a tick (``list_unschedulable_pods``, the loop's safety gate)
freezes the live stores into a per-tick view, so a tick never sees a pod
on two nodes because an event arrived mid-tick. Writes (evictions, taints,
events) pass through to the underlying client unchanged.

The port of the JAX package's ``io/watch.py``. A node or pod LIST, seed
or re-list after a 410 Gone or a dropped stream, decodes in one native
pass (``io/native_ingest``) into lazy views when the client allows it;
``ColumnarFeed`` then seeds the empty mirror from that one batch
(``ColumnarStore.bulk_add_pods``) and falls back to ``add_pod`` per pod
otherwise. The anti-entropy audit's LIST decodes through the Python
decoders, the path the mirror's events take.
"""

from __future__ import annotations

import socket
import threading
import urllib.error
from typing import Callable, Dict, List, Optional, Tuple

from k8s_spot_rescheduler_tpu_torch.io.kube import (
    KubeClusterClient,
    decode_node,
    decode_pdb,
    decode_pod,
)
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.cluster import NodeSpec, PDBSpec, PodSpec
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock, RealClock
from k8s_spot_rescheduler_tpu_torch.utils import logging as log

# The server closes an idle watch after this many seconds and we reconnect
# from the last seen resourceVersion; the socket timeout sits above it so a
# healthy-but-idle stream is never mistaken for a dead one.
WATCH_TIMEOUT_SECONDS = 300
RECONNECT_BACKOFF_INITIAL = 1.0
RECONNECT_BACKOFF_MAX = 30.0
# Slack added to the client-side socket timeout above the progress
# deadline: with timeoutSeconds capped AT the deadline, a healthy server
# always closes the stream first — only a wedged transport ever reaches
# the socket timeout, so the timeout firing IS the stall verdict.
WATCH_STALL_SLACK = 30.0


def _is_timeout(err: Exception) -> bool:
    """True for the socket-read timeout family a wedged-open stream
    produces (bare ``TimeoutError``/``socket.timeout`` during body
    reads, or URLError-wrapped when it fires at connect time)."""
    timeouts = (TimeoutError, socket.timeout)
    if isinstance(err, timeouts):
        return True
    return isinstance(err, urllib.error.URLError) and isinstance(
        getattr(err, "reason", None), timeouts
    )


class ResourceStore:
    """Thread-safe keyed store for one resource type, fed by a watcher.

    An optional listener (``subscribe``) observes every mutation under the
    store lock — the hook the columnar delta feed rides on. The listener
    must be cheap and non-blocking (it appends to a deque).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._items: Dict[str, object] = {}
        self.synced = threading.Event()
        self._listener = None  # callable(action, key, obj) under lock

    def subscribe(self, listener) -> List[object]:
        """Install the mutation listener and return the current items —
        atomically, so the subscriber misses no event and sees none twice."""
        with self._lock:
            self._listener = listener
            return list(self._items.values())

    def replace(self, items: Dict[str, object]) -> None:
        with self._lock:
            self._items = dict(items)
            if self._listener is not None:
                self._listener("replace", "", list(items.values()))
        self.synced.set()

    def upsert(self, key: str, obj: object, guard=None) -> bool:
        """``guard`` (checked under the store lock) lets a watcher make
        its apply atomic with a cancellation flag: a thread that passed
        its pre-check and then blocked on this lock while an audit
        replaced the store must not land its stale object afterwards."""
        with self._lock:
            if guard is not None and not guard():
                return False
            self._items[key] = obj
            if self._listener is not None:
                self._listener("upsert", key, obj)
            return True

    def delete(self, key: str, guard=None) -> bool:
        with self._lock:
            if guard is not None and not guard():
                return False
            old = self._items.pop(key, None)
            if old is not None and self._listener is not None:
                self._listener("delete", key, old)
            return True

    def snapshot(self) -> List[object]:
        with self._lock:
            return list(self._items.values())

    def snapshot_items(self) -> List[tuple]:
        """(key, obj) pairs — for callers that must upsert back under the
        SAME key (watch keys are apiserver UIDs, not ns/name)."""
        with self._lock:
            return list(self._items.items())

    def replace_if_same(self, key: str, old: object, new: object) -> bool:
        """Upsert ``new`` only if ``key`` still maps to ``old`` — the
        compare-and-swap for read-resolve-writeback callers racing the
        watcher thread (a concurrent MODIFIED/DELETED wins)."""
        with self._lock:
            if self._items.get(key) is not old:
                return False
            self._items[key] = new
            if self._listener is not None:
                self._listener("upsert", key, new)
            return True

    @property
    def lock(self) -> threading.Lock:
        """The store's mutation lock — for multi-store atomic freezes."""
        return self._lock

    def items_unlocked(self) -> List[object]:
        """Like snapshot() but the caller already holds .lock."""
        return list(self._items.values())


class _Expired(Exception):
    """resourceVersion too old — fall back to a fresh LIST."""


class Watcher(threading.Thread):
    """Background list-then-watch loop keeping one ResourceStore current.

    Liveness: every sign of progress — an applied event, a BOOKMARK, a
    clean server-side stream close, a successful (re-)LIST — stamps
    ``last_progress_wall`` from the injected clock. ``staleness()`` is
    the mirror-trust primitive the controller's freshness gate reads.
    With a ``progress_deadline`` set, the watch's server-side
    ``timeoutSeconds`` is capped at the deadline (a healthy-but-idle
    server then closes the stream within it, which counts as progress)
    and the client socket timeout sits ``WATCH_STALL_SLACK`` above it —
    so the socket timeout firing means the transport was open but
    wedged: the stream is killed, counted in ``watch_stalls_total``,
    and reconnected from the still-valid resourceVersion WITHOUT a
    re-LIST (nothing was missed; a wedge is not data loss).

    The protocol loop is a sequence of ``step()`` calls so a virtual-
    clock soak can drive it synchronously; ``run()`` just loops it on
    the daemon thread.
    """

    def __init__(
        self,
        client: KubeClusterClient,
        list_path: str,
        decode: Callable[[dict], object],
        key: Callable[[dict], str],
        store: ResourceStore,
        *,
        name: str = "watcher",
        clock: Optional[Clock] = None,
        progress_deadline: float = 0.0,
        wait_fn: Optional[Callable[[float], None]] = None,
    ) -> None:
        super().__init__(name=f"watch-{name}", daemon=True)
        self.client = client
        self.list_path = list_path
        self.decode = decode
        self.key = key
        self.store = store
        self.resource = name
        self.clock = clock or RealClock()
        self.progress_deadline = float(progress_deadline)
        # reconnect-backoff sleeps go through wait_fn when injected (the
        # synchronous soak passes the fake clock's sleep); the default
        # waits on the stop event so stop() returns promptly mid-backoff
        self._wait_fn = wait_fn
        # NOT named _stop: threading.Thread.join() internally calls a
        # private self._stop() method, which an Event attribute of the
        # same name would shadow (TypeError on join after exit)
        self._stopped = threading.Event()
        # observability for tests and debugging (mirrored into the
        # watch_* Prometheus series as they change)
        self.relist_count = 0
        self.event_count = 0
        self.stream_error_count = 0
        self.stall_count = 0
        # wall timestamp of the last proven progress; None until the
        # seeding LIST lands (staleness reads as infinite before then)
        self.last_progress_wall: Optional[float] = None
        # protocol-loop state (owned by step(); run() is just the loop)
        self._rv = ""
        self._need_list = True
        self._backoff = RECONNECT_BACKOFF_INITIAL
        # set by restart_from(): resume watching at this version without
        # a re-LIST (the anti-entropy audit already replaced the store)
        self._resume_rv: Optional[str] = None
        # invoked after every successful re-LIST (seed or 410 recovery);
        # the watching client uses it to re-arm scans that full store
        # replacement could invalidate (e.g. unresolved-PVC tracking)
        self.on_relist: Optional[Callable[[], None]] = None

    def stop(self) -> None:
        self._stopped.set()

    # --- liveness ---

    def note_progress(self) -> None:
        """Stamp proven liveness: an event landed, the server closed the
        stream cleanly, a (re-)LIST succeeded, or an anti-entropy audit
        just proved (or restored) mirror-equals-LIST."""
        self.last_progress_wall = self.clock.wall()

    def staleness(self, now_wall: Optional[float] = None) -> float:
        """Wall seconds since this watcher last proved progress;
        infinite before the seeding LIST."""
        if self.last_progress_wall is None:
            return float("inf")
        if now_wall is None:
            now_wall = self.clock.wall()
        return max(0.0, now_wall - self.last_progress_wall)

    def restart_from(self, rv: str) -> None:
        """Abandon the current stream (at its next event boundary) and
        resume watching from ``rv`` WITHOUT a re-LIST — the anti-entropy
        audit just replaced the store from a LIST at exactly that
        version, so the running stream (which provably missed or
        corrupted updates) must not keep feeding it, and a second LIST
        would be pure waste."""
        self._resume_rv = rv

    def _wait(self, seconds: float) -> None:
        if self._wait_fn is not None:
            self._wait_fn(seconds)
        else:
            self._stopped.wait(seconds)

    # --- protocol steps ---

    def _native_relist(self):
        """LIST via the native ingest engine when it applies: returns
        (items dict keyed by metadata.uid, resourceVersion) or None."""
        from k8s_spot_rescheduler_tpu_torch.io import native_ingest

        if not getattr(self.client, "use_native_ingest", True):
            return None
        if not native_ingest.available():
            return None
        parse = {
            "/api/v1/pods": native_ingest.parse_pod_list,
            "/api/v1/nodes": native_ingest.parse_node_list,
        }.get(self.list_path)
        if parse is None:
            return None
        batch = parse(self.client._request_raw("GET", self.list_path))
        if batch is None:
            return None  # body didn't parse; Python path will retry
        items = {}
        for view in batch.views():
            key = view.meta_uid
            if not key:
                # a uid-less object can't be keyed consistently with the
                # raw-dict _meta_key later watch events will use — let the
                # Python re-list handle this (test/fake servers only; real
                # apiservers always set metadata.uid)
                return None
            items[key] = view
        return items, batch.resource_version

    def _fetch(self, *, native: bool = True):
        """One full LIST, decoded: (items dict, resourceVersion). The
        anti-entropy audit passes ``native=False`` so its items decode
        through the exact per-event Python path the mirror's contents
        came from (comparable field-by-field)."""
        if native:
            got = self._native_relist()
            if got is not None:
                return got
        obj = self.client._request("GET", self.list_path)
        items = {}
        for raw in obj.get("items", []) or []:
            items[self.key(raw)] = self.decode(raw)
        rv = (obj.get("metadata", {}) or {}).get("resourceVersion", "")
        return items, rv

    def _relist(self) -> str:
        items, rv = self._fetch()
        self.store.replace(items)
        self.relist_count += 1
        metrics.update_watch_relist(self.resource)
        self.note_progress()
        if self.on_relist is not None:
            self.on_relist()
        log.vlog(
            3, "watch %s: listed %d items at rv=%s",
            self.resource, len(items), rv,
        )
        return rv

    def _apply(self, event: dict, rv: str) -> str:
        etype = event.get("type", "")
        obj = event.get("object", {}) or {}
        if etype == "BOOKMARK":
            return (obj.get("metadata", {}) or {}).get("resourceVersion", rv)
        if etype == "ERROR":
            # k8s encodes watch failures as a Status object; 410 means the
            # resourceVersion fell out of etcd's window — re-list.
            code = int(obj.get("code", 0) or 0)
            reason = obj.get("reason", "")
            if code == 410 or reason == "Expired":
                raise _Expired(obj.get("message", "resourceVersion expired"))
            raise RuntimeError(f"watch ERROR event: {obj}")
        key = self.key(obj)
        # guarded apply, atomic with the restart flag UNDER the store
        # lock: if this thread passed the stream loop's pre-check and
        # then blocked on the lock while an audit heal replaced the
        # store (the audit sets _resume_rv BEFORE replacing), the stale
        # object must not land on top of the healed state
        guard = (
            lambda: self._resume_rv is None and not self._stopped.is_set()
        )
        if etype in ("ADDED", "MODIFIED"):
            applied = self.store.upsert(key, self.decode(obj), guard=guard)
        elif etype == "DELETED":
            applied = self.store.delete(key, guard=guard)
        else:
            applied = True
        if applied:
            self.event_count += 1
            metrics.update_watch_event(self.resource)
        return (obj.get("metadata", {}) or {}).get("resourceVersion", rv)

    def _watch(self, rv: str) -> str:
        sep = "&" if "?" in self.list_path else "?"
        # with a progress deadline the server-side timeout is capped AT
        # it, so a healthy idle stream is cleanly closed (= progress)
        # before the client-side socket timeout — which then only ever
        # fires on a genuinely wedged transport
        if self.progress_deadline > 0:
            server_timeout = min(
                WATCH_TIMEOUT_SECONDS, max(1, int(self.progress_deadline))
            )
            read_timeout = self.progress_deadline + WATCH_STALL_SLACK
        else:
            server_timeout = WATCH_TIMEOUT_SECONDS
            read_timeout = WATCH_TIMEOUT_SECONDS + WATCH_STALL_SLACK
        path = (
            f"{self.list_path}{sep}watch=1&allowWatchBookmarks=true"
            f"&timeoutSeconds={server_timeout}"
            + (f"&resourceVersion={rv}" if rv else "")
        )
        for event in self.client._stream(path, read_timeout):
            # the resume/stop check runs BEFORE the apply: after an
            # audit heal (restart_from), one more event from the
            # abandoned stream would otherwise land ON TOP of the
            # healed store — stale content the resumed stream (which
            # starts past it) would never redeliver
            if self._stopped.is_set() or self._resume_rv is not None:
                break
            self.note_progress()
            rv = self._apply(event, rv)
        return rv

    def step(self) -> None:
        """One protocol iteration: honor a pending audit restart,
        (re-)LIST if needed, then consume one watch stream to its end
        (server close, error, stall, or stop). ``run`` loops this on
        the watcher thread; the seeded soak drives it synchronously."""
        resume = self._resume_rv
        if resume is not None:
            self._resume_rv = None
            self._rv = resume
            self._need_list = False
        watching = False
        try:
            if self._need_list:
                self._rv = self._relist()
                self._need_list = False
            watching = True
            self._rv = self._watch(self._rv)
            # server closed the stream normally (timeoutSeconds) —
            # proven progress; reconnect from the last version without
            # re-listing
            self.note_progress()
            self._backoff = RECONNECT_BACKOFF_INITIAL
        except _Expired:
            # brief pause before the full re-LIST: if etcd's compaction
            # window is shorter than our LIST+watch turnaround, an
            # unthrottled loop here would hammer the apiserver with
            # back-to-back full LISTs
            log.vlog(2, "watch %s: resourceVersion expired, re-listing "
                        "in %.1fs", self.resource, self._backoff)
            self._need_list = True
            self._wait(self._backoff)
            self._backoff = min(self._backoff * 2, RECONNECT_BACKOFF_MAX)
        except Exception as err:  # noqa: BLE001 — any transport error
            if self._stopped.is_set():
                return
            if watching and self.progress_deadline > 0 and _is_timeout(err):
                # open-but-silent stream killed by the client-side
                # progress deadline: the resourceVersion is still valid
                # (a wedge loses no events), so reconnect immediately
                # without a re-LIST — the deadline itself throttles a
                # server that keeps stalling. ``watching`` scopes this
                # to the stream: a timing-out LIST is an ordinary
                # transport error and must keep its exponential backoff
                # (the branch below), never a tight relist loop
                self.stall_count += 1
                metrics.update_watch_stall(self.resource)
                # same event, third surface: the flight recorder keeps
                # the stall in the postmortem ring beside the counters
                # (fires on the watcher thread — between ticks — so no
                # tick trace ID to carry)
                from k8s_spot_rescheduler_tpu_torch.loop import flight

                flight.note_event(
                    "watch-stall",
                    cause="stream open but silent past the %.0fs "
                          "progress deadline; reconnected from rv=%s"
                          % (self.progress_deadline, self._rv),
                    resource=self.resource,
                )
                log.error(
                    "watch %s: stream open but silent past the %.0fs "
                    "progress deadline; killing and reconnecting from "
                    "rv=%s", self.resource, self.progress_deadline,
                    self._rv,
                )
                self._backoff = RECONNECT_BACKOFF_INITIAL
                return
            self.stream_error_count += 1
            metrics.update_watch_stream_error(self.resource)
            log.vlog(
                2, "watch %s: stream error (%s), retrying in %.1fs",
                self.resource, err, self._backoff,
            )
            self._need_list = True  # conservative: reconcile after an error
            self._wait(self._backoff)
            self._backoff = min(self._backoff * 2, RECONNECT_BACKOFF_MAX)

    def run(self) -> None:
        while not self._stopped.is_set():
            self.step()


def _audit_norm(obj):
    """Comparable form of a stored/fetched object for the anti-entropy
    diff. Native lazy views materialize to their spec dataclasses (the
    two decode paths are lockstep by contract, so equal JSON compares
    equal), and ``pvc_resolvable`` is masked out on pods: it is a
    resolution-retry control flag, not cluster state — a terminally
    unresolvable claim flips it in the mirror only (via writeback), and
    flagging that as drift would heal-loop every audit."""
    import dataclasses

    if hasattr(obj, "to_pod_spec"):
        obj = obj.to_pod_spec()
    elif hasattr(obj, "to_node_spec"):
        obj = obj.to_node_spec()
    if isinstance(obj, PodSpec) and obj.pvc_resolvable:
        obj = dataclasses.replace(obj, pvc_resolvable=False)
    return obj


def _shared_batch(objs):
    """The native PodBatch behind a list of PodViews, if they all share
    one (a LIST seeds the store from a single batch)."""
    if not objs:
        return None
    batch = getattr(objs[0], "_b", None)
    if batch is None or not hasattr(batch, "tol_sets"):
        return None
    if all(getattr(o, "_b", None) is batch for o in objs) and len(objs) == (
        batch.count
    ):
        return batch
    return None


class ColumnarFeed:
    """Bridges the watch caches into a ``models/columnar.ColumnarStore``.

    Watcher threads enqueue deltas (under the store lock, via
    ``ResourceStore.subscribe``); the control-loop thread drains the queue
    once per tick (``sync``) and applies it to the columnar arrays — so
    the numpy state is only ever touched from one thread, and a tick sees
    a frozen point-in-time cluster, exactly like the object snapshot.

    A watcher re-list (410 Gone recovery) arrives as one ``replace`` delta
    and is reconciled by key diff: vanished objects are removed, everything
    present is upserted (same-node pod upserts keep their slot order).
    """

    def __init__(self, store, nodes: ResourceStore, pods: ResourceStore):
        import collections

        self.store = store
        # every mutation reaches the store through its mutators (watch
        # events decode fresh objects), so the version-keyed pack memo
        # is sound here: a zero-delta tick re-reads the previous pack
        store.pack_memo_enabled = True
        self._deltas = collections.deque()  # (kind, action, obj)
        # subscribe atomically: the returned seed lists are exactly the
        # state before any queued delta (no missed or doubled events)
        for obj in nodes.subscribe(
            lambda a, k, o: self._deltas.append(("node", a, o))
        ):
            self._apply("node", "upsert", obj)
        pod_seed = pods.subscribe(
            lambda a, k, o: self._deltas.append(("pod", a, o))
        )
        batch = _shared_batch(pod_seed)
        if batch is None or not store.bulk_add_pods(batch):
            for obj in pod_seed:
                self._apply("pod", "upsert", obj)

    def _apply(self, kind: str, action: str, obj) -> None:
        store = self.store
        if kind == "pod":
            if action == "upsert":
                store.add_pod(obj)
            elif action == "delete":
                store.remove_pod(obj.uid)
            else:  # replace (re-list after 410 Gone)
                batch = _shared_batch(obj)
                if batch is not None and store.bulk_add_pods(batch):
                    return  # empty store seeded in one vectorized pass
                store.reconcile_pods(obj)
        else:
            if action == "upsert":
                store.add_node(obj)
            elif action == "delete":
                store.remove_node(obj.name)
            else:  # replace
                store.reconcile_nodes(obj)

    def sync(self) -> int:
        """Drain queued deltas into the columnar store (tick thread only).
        Returns the number of deltas applied."""
        n = 0
        while self._deltas:
            kind, action, obj = self._deltas.popleft()
            self._apply(kind, action, obj)
            n += 1
        return n


class WatchingKubeClusterClient:
    """ClusterClient served from watch caches; writes pass through.

    Wraps a ``KubeClusterClient`` (which keeps doing the write path and
    provides the HTTP plumbing) with three watchers matching the
    reference's listers. ``list_unschedulable_pods`` — the first read of
    every housekeeping tick — freezes the live stores into a consistent
    per-tick snapshot.
    """

    def __init__(
        self,
        client: KubeClusterClient,
        *,
        clock: Optional[Clock] = None,
        progress_deadline: float = 0.0,
        wait_fn: Optional[Callable[[float], None]] = None,
    ) -> None:
        self.client = client
        self.clock = clock or RealClock()
        self.nodes = ResourceStore()
        self.pods = ResourceStore()
        self.pdbs = ResourceStore()
        # PVC/PV snapshots for volume-affinity resolution
        # (models/volumes.py): seeded before the pod watcher starts (a
        # running pod's binding pre-dates it) and refreshed per tick
        # while unresolved claims remain. Resolution failures leave pods
        # conservatively unplaceable. Held as ONE tuple so the watcher
        # thread's decode reads a consistent (pvcs, pvs) pair while the
        # tick thread reassigns it (advisor r3: two separate attribute
        # loads could pair a new PVC map with an old PV map).
        self._vol_snapshot: Tuple[Dict[str, object], Dict[str, object]] = (
            {}, {},
        )
        # re-scan the pod store for unresolved PVC pods only when
        # something could have produced one: the decode hook saw an
        # unresolved pod, or a re-LIST replaced the store wholesale
        # (the native bulk path bypasses the hook). Keeps the per-tick
        # _refresh_volumes a pure no-op for clusters without claims —
        # a 50k-pod python scan per tick would cost real time.
        self._vol_scan_needed = True
        self._watchers = [
            Watcher(client, "/api/v1/nodes", decode_node,
                    self._meta_key, self.nodes, name="nodes",
                    clock=self.clock, progress_deadline=progress_deadline,
                    wait_fn=wait_fn),
            Watcher(client, "/api/v1/pods", self._decode_pod_resolved,
                    self._meta_key, self.pods, name="pods",
                    clock=self.clock, progress_deadline=progress_deadline,
                    wait_fn=wait_fn),
            Watcher(client, "/apis/policy/v1/poddisruptionbudgets",
                    decode_pdb, self._meta_key, self.pdbs, name="pdbs",
                    clock=self.clock, progress_deadline=progress_deadline,
                    wait_fn=wait_fn),
        ]
        self._watchers[1].on_relist = self._arm_volume_scan
        # per-tick frozen view: node_name -> pods
        self._pods_by_node: Dict[str, List[PodSpec]] = {}
        self._tick_nodes: List[NodeSpec] = []
        self._tick_pdbs: List[PDBSpec] = []
        self._have_tick_view = False
        self._feed = None  # lazily attached ColumnarFeed

    # --- columnar fast path ---

    def columnar_store(
        self, resources, *, on_demand_label: str, spot_label: str
    ):
        """The incrementally-maintained columnar mirror, fed by the watch
        streams ("watch → numpy buffers"). Each call syncs
        queued watch deltas into the arrays — call it once per tick, from
        the control-loop thread."""
        from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore

        feed = self._feed
        if (
            feed is None
            or feed.store.resources != tuple(resources)
            or feed.store.on_demand_label != on_demand_label
            or feed.store.spot_label != spot_label
        ):
            store = ColumnarStore(
                resources,
                on_demand_label=on_demand_label,
                spot_label=spot_label,
            )
            feed = self._feed = ColumnarFeed(store, self.nodes, self.pods)
            # the seed read the live stores, which may be newer than the
            # tick's frozen object view — re-freeze so PDBs and the gate
            # view line up with the columnar state (one consistent instant)
            self._freeze()
        else:
            # columnar deltas are drained inside _freeze(), so the mirror
            # is exactly as old as the tick's frozen object/PDB view
            self._view()
        return feed.store

    @staticmethod
    def _meta_key(obj: dict) -> str:
        meta = obj.get("metadata", {}) or {}
        return meta.get("uid") or (
            meta.get("namespace", "") + "/" + meta.get("name", "")
        )

    # --- volume-affinity resolution ---

    def _decode_pod_resolved(self, obj: dict):
        from k8s_spot_rescheduler_tpu_torch.models.volumes import (
            resolve_volume_affinity,
        )

        pod = decode_pod(obj)
        if pod.pvc_resolvable:
            pvcs, pvs = self._vol_snapshot  # one load: consistent pair
            pod = resolve_volume_affinity(pod, pvcs, pvs)
            if pod.pvc_resolvable:  # still unresolved: retry per tick
                self._vol_scan_needed = True
        return pod

    def _arm_volume_scan(self) -> None:
        self._vol_scan_needed = True

    def _refresh_volumes(self, force: bool = False) -> None:
        """Refetch the PVC/PV snapshots (cheap LISTs — these objects are
        few relative to pods) and re-resolve any still-unresolved PVC
        pods in the store. Skipped entirely while no pod carries
        resolvable claims; any failure keeps the old snapshot (pods stay
        conservatively unplaceable)."""
        import dataclasses

        from k8s_spot_rescheduler_tpu_torch.models.cluster import PodSpec
        from k8s_spot_rescheduler_tpu_torch.models.volumes import (
            resolve_volume_affinity,
            terminally_unresolvable,
        )

        if not self._vol_scan_needed and not force:
            return
        unresolved = [
            (key, p) for key, p in self.pods.snapshot_items()
            if getattr(p, "pvc_resolvable", False)
        ]
        if not unresolved:
            self._vol_scan_needed = False
            if not force:
                return
        try:
            pvcs, pvs = self.client.list_volume_snapshots()
            self._vol_snapshot = (pvcs, pvs)  # single atomic reassignment
        except Exception as err:  # noqa: BLE001, exception-discipline — stay conservative: unresolved volume pods remain unmodeled (the SAFE direction) and retry next tick; the kube retry layer counted the read failure
            log.error("PVC/PV list failed; volume pods stay unmodeled: %s", err)
            return
        for key, pod in unresolved:
            spec = pod if isinstance(pod, PodSpec) else pod.to_pod_spec()
            resolved = resolve_volume_affinity(spec, pvcs, pvs)
            if resolved is spec:
                if terminally_unresolvable(spec, pvcs, pvs):
                    # PV affinity is immutable: stop re-LISTing volumes
                    # for this pod every tick; it stays unmodeled
                    resolved = dataclasses.replace(spec, pvc_resolvable=False)
                else:
                    continue  # binding may still appear: retry next tick
            # writeback races the watcher thread: a concurrent MODIFIED/
            # DELETED event must win over this stale-read resolution
            self.pods.replace_if_same(key, pod, resolved)
        # retry only while a non-terminal unresolved pod remains
        self._vol_scan_needed = any(
            getattr(p, "pvc_resolvable", False)
            for p in self.pods.snapshot()
        )

    # --- lifecycle ---

    def start(
        self, timeout: Optional[float] = 30.0, *, background: bool = True
    ) -> None:
        """Start the watchers and block until every store has synced its
        initial LIST — the reference likewise waits for informer cache
        sync before the loop's first tick. ``background=False`` runs one
        synchronous protocol step per watcher instead of starting the
        threads — the deterministic mode the virtual-clock soak drives
        (it then calls ``Watcher.step()`` itself)."""
        # seed the PVC/PV maps BEFORE the pod watcher so JSON watch
        # events decode resolved from the first pod...
        self._refresh_volumes(force=True)
        if background:
            for w in self._watchers:
                w.start()
            for w in self._watchers:
                if not w.store.synced.wait(timeout):
                    raise TimeoutError(
                        f"watch cache for {w.resource} failed to sync "
                        f"within {timeout}s"
                    )
        else:
            for w in self._watchers:
                w.step()
                if not w.store.synced.is_set():
                    raise TimeoutError(
                        f"watch cache for {w.resource} failed to sync"
                    )
        # ...and resolve again AFTER the seed sync: the native bulk
        # relist path emits lazy views that bypass the decode hook
        self._refresh_volumes()

    def stop(self) -> None:
        for w in self._watchers:
            w.stop()

    # --- freshness and anti-entropy (docs/ROBUSTNESS.md) ---

    def mirror_staleness(self) -> float:
        """Wall seconds since the LEAST-live watch stream last proved
        progress — the controller's freshness gate refuses to plan from
        the mirror past ``mirror_staleness_budget``. Infinite until
        every store has seeded."""
        now = self.clock.wall()
        return max(w.staleness(now) for w in self._watchers)

    def direct_client(self):
        """The wrapped polling client — the freshness gate's bypass
        path. Its reads go straight to the apiserver (one LIST per
        view), never consulting the possibly-sick watch caches; writes
        were passing through to it anyway."""
        return self.client

    def resync_audit(self) -> Dict[str, int]:
        """Anti-entropy pass: one fresh LIST per watched resource,
        diffed field-by-field against the incremental mirror. Drift —
        a missing object, a phantom, or any field divergence — forces
        the store to be replaced from the LIST (one ``replace`` delta:
        the columnar feed reconciles and the planner full-repacks) and
        the watcher to resume from the LIST's resourceVersion; it is
        counted per object in ``watch_drift_total``. A clean audit
        proves mirror==LIST, which re-stamps watch liveness for free.
        Returns {resource: drifted object count}; raises if a LIST
        fails (the controller logs and retries next interval)."""
        drift: Dict[str, int] = {}
        for w in self._watchers:
            # Churn tolerance (threaded mode): the watcher keeps
            # applying events while the LIST is fetched and diffed, and
            # the mirror may legitimately run AHEAD of the LIST for
            # objects that changed mid-audit. An entry only counts as
            # drifted if the mirror's copy is IDENTICAL (by object)
            # before and after the fetch — untouched across the whole
            # audit window — yet still disagrees with the LIST. Every
            # mirror entry predates the LIST request, so an untouched
            # divergent entry cannot be explained by in-audit churn.
            # (An event still in flight when the LIST was issued can be
            # flagged; the heal then merely fast-forwards the store to
            # the LIST's newer state — converging, never corrupting.)
            pre = dict(w.store.snapshot_items())
            items, rv = w._fetch(native=False)
            current = dict(w.store.snapshot_items())
            n_field = n_presence = 0
            for k in set(items) | set(current):
                if current.get(k) is not pre.get(k):
                    continue  # touched mid-audit: churn, not drift
                a, b = items.get(k), current.get(k)
                if a is None or b is None:
                    # presence divergence (missing or phantom object):
                    # often an ADDED/DELETED event still in flight at
                    # the LIST instant — healed, but counted apart from
                    # the alarm-grade field drift below
                    n_presence += 1
                elif _audit_norm(a) != _audit_norm(b):
                    n_field += 1
            n = n_field + n_presence
            drift[w.resource] = n
            if n:
                log.error(
                    "anti-entropy audit: %s mirror diverged from a "
                    "fresh LIST (%d field-drifted, %d missing/phantom); "
                    "replacing the store (rv=%s)",
                    w.resource, n_field, n_presence, rv,
                )
                if n_field:
                    metrics.update_watch_drift(w.resource, n_field)
                if n_presence:
                    metrics.update_watch_presence_heal(
                        w.resource, n_presence
                    )
                # restart BEFORE replace: a watcher thread blocked on
                # the store lock mid-apply re-checks _resume_rv under
                # that same lock (the guarded apply), so no stale event
                # from the abandoned stream can land on the healed state
                w.restart_from(rv)
                w.store.replace(items)
                if w.on_relist is not None:
                    w.on_relist()
            # clean or healed, the mirror now provably equals a fresh
            # LIST: that is progress even if the stream is wedged
            w.note_progress()
        metrics.update_resync_audit()
        # the frozen per-tick view may predate a heal; re-freeze lazily
        if any(drift.values()):
            self._have_tick_view = False
        return drift

    # --- consistent per-tick view ---

    def refresh(self) -> None:
        """Drop the frozen view so the next read re-freezes from the live
        stores — called by the control loop before a mid-tick re-observe
        (multi-drain re-plan), mirroring KubeClusterClient.refresh().
        Also the per-tick hook where unresolved PVC pods retry against a
        fresh PVC/PV snapshot (no-op while none exist)."""
        self._refresh_volumes()
        self._have_tick_view = False

    def _freeze(self) -> None:
        # The columnar mirror freezes at the same instant as the object
        # view and the PDB list: one consistent per-tick cluster state.
        # All three store locks are held while the delta feed drains and
        # the object views are copied — watcher threads mutate (and
        # enqueue deltas) only under their store's lock, so nothing can
        # land between the mirror drain and the object snapshot.
        n_deltas = 0
        with self.nodes.lock, self.pods.lock, self.pdbs.lock:
            if self._feed is not None:
                n_deltas = self._feed.sync()
            by_node: Dict[str, List[PodSpec]] = {}
            for pod in self.pods.items_unlocked():
                by_node.setdefault(pod.node_name, []).append(pod)
            self._pods_by_node = by_node
            self._tick_nodes = list(self.nodes.items_unlocked())
            self._tick_pdbs = list(self.pdbs.items_unlocked())
        self._have_tick_view = True
        if self._feed is not None:
            # outside the store locks: prometheus takes its own
            metrics.update_observe_delta_events(n_deltas)

    def _view(self) -> None:
        if not self._have_tick_view:
            self._freeze()

    # --- read path (lister equivalents) ---

    def list_unschedulable_pods(self) -> List[PodSpec]:
        # first read of every tick: retry any unresolved PVC pods
        # against a fresh PVC/PV snapshot (no-op while none exist),
        # then refresh the frozen view
        self._refresh_volumes()
        self._freeze()
        return [
            p for p in self._pods_by_node.get("", [])
            if p.phase == "Pending"
        ]

    def list_ready_nodes(self) -> List[NodeSpec]:
        self._view()
        return [n for n in self._tick_nodes if n.ready]

    def list_unready_nodes(self) -> List[NodeSpec]:
        # presence-only view (NodeMap.unready; zone/spread counts)
        self._view()
        return [n for n in self._tick_nodes if not n.ready]

    def list_pods_on_node(self, node_name: str) -> List[PodSpec]:
        self._view()
        return list(self._pods_by_node.get(node_name, []))

    def list_pdbs(self) -> List[PDBSpec]:
        self._view()
        return list(self._tick_pdbs)

    def get_pod(self, namespace: str, name: str) -> Optional[PodSpec]:
        # actuation-path read (eviction verify poll, scaler/scaler.go:123):
        # must see live state, not the tick snapshot — a pod that just
        # terminated has to read as gone, so go straight to the apiserver.
        return self.client.get_pod(namespace, name)

    # --- write path + events: pass through ---

    def evict_pod(self, pod: PodSpec, grace_seconds: int) -> None:
        self.client.evict_pod(pod, grace_seconds)

    def add_taint(self, node_name: str, taint) -> None:
        self.client.add_taint(node_name, taint)

    def remove_taint(self, node_name: str, taint_key: str) -> None:
        self.client.remove_taint(node_name, taint_key)

    def event(self, *args, **kwargs) -> None:
        self.client.event(*args, **kwargs)
