"""Per-tick tracing: span trees and phase timers.

The reference's only observability into its hot path is glog verbosity
(SURVEY.md §5.1); here every housekeeping tick carries an in-process
*trace* — a tick-scoped trace ID plus a tree of nested ``span`` records
(monotonic start/duration, typed attributes) — threaded through the
control loop, the kube read path, the actuator and the planner, and
*across the service wire*: the agent ships its trace ID with each plan
request (``X-Trace-Id`` header + a wire frame, service/wire.py v2) and
the planner service returns its own spans (admit, decode, queue-wait,
batch assembly, solve, encode) compactly in the reply, which the agent
grafts into the tick's tree. One tree answers "queue or solve or wire?"
for any given slow tick. Completed traces feed the flight recorder
(loop/flight.py); the last tree is inspectable via ``/debug/trace``.

Tracing is always-on-cheap: O(spans) host work per tick (dict/list
appends + ``perf_counter`` reads), zero device syncs, and a hard
``MAX_SPANS`` cap so a pathological tick cannot grow a trace without
bound (drops are counted on the trace). ``trace_enabled`` (config)
turns the whole layer off.

Host syncs. Every blocking device-to-host read on the plan paths goes
through ``utils/syncs.device_sync``, which counts it in
``device_syncs_total{site}`` and, under a trace, times it as a
``device.sync`` span.

Phases of the pipelined tick (loop/controller.py): ``observe`` (cluster
state + PDBs), ``plan-dispatch`` (host pack + delta-upload + async solve
dispatch), ``observe-metrics`` (per-node metrics — host work that runs
WHILE the device solve is in flight), ``plan-fetch`` (the blocking
selection fetch + report build), ``actuate``. The aggregate ``plan``
series (dispatch + fetch, excluding the overlapped window) is kept for
dashboard continuity; ``plan-fetch`` minus the true device time is the
residual the overlap did not hide.

Span-name registry
------------------
Every span name emitted anywhere in the package MUST be declared in
``SPAN_NAMES`` below and vice versa — enforced by the ``trace-contract``
static-analysis pass (tools/analysis/passes/contracts.py), so dashboards
and the flight-recorder schema cannot silently drift. Emit spans only
through this module's ``phase(...)`` / ``span(...)`` / ``make_span(...)``
helpers with a literal name (that is what the pass scans).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, Iterable, List, Optional, Tuple

from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.utils import logging as log

# name -> one-line meaning. The single source of truth for every span
# emitted anywhere (docs/OBSERVABILITY.md renders this table; the
# trace-contract pass enforces both directions).
SPAN_NAMES: Dict[str, str] = {
    # control-loop tick phases (loop/controller.py, via phase())
    "observe": "cluster state + PDB listing (object or columnar path)",
    "plan": "aggregate plan phase (dispatch + fetch, overlap excluded)",
    "plan-dispatch": "host pack + delta upload + async solve dispatch",
    "observe-metrics": "per-node metrics pass (overlaps the device solve)",
    "plan-fetch": "blocking selection fetch + PlanReport build",
    "actuate": "drain actuation (taint, evict, verify, untaint)",
    # kube API read path (io/kube.py retry loop)
    "kube.get": "one kube API read incl. transient retries (attempts attr)",
    # actuator rounds (actuator/drain.py)
    "drain.evict": "one parallel eviction round over the remaining pods",
    "drain.verify": "one verification poll round over the drained pods",
    # planner internals (planner/solver_planner.py, service/agent.py)
    "plan.pack": "host pack of the observation into problem tensors",
    "plan.delta-upload": "device-resident cache update (delta or repack)",
    "plan.solve": "the solve the tick actually waited on (fetch/oracle)",
    "plan.schedule": "drain-to-exhaustion schedule cut: one fetch, H steps",
    # inside the plan (models/columnar.py, solver/fallback.py,
    # solver/repair.py, solver/schedule.py and utils/syncs.py)
    "pack.verdicts": "the pack's evictability, PDB and node-class verdicts",
    "pack.order": "candidate and spot orders, blocking pods and slot order",
    "pack.spread": "hard topology-spread contexts of the packed pods",
    "pack.predicates": "zone pod-affinity contexts, taint table, tolerations "
                       "and the affinity matrix of the pack",
    "pack.fill": "the problem arrays: lanes, slots and the spot pool's state",
    "union.greedy": "one union solve's greedy passes (B1, B2 and their merge)",
    "union.repair": "one union solve's repair, where the greedy passes left "
                    "a valid lane unproven (lanes attr: how many)",
    "repair.partial": "repair's partial best-fit pass over the K slots",
    "repair.rounds": "every round of repair's eject-and-reinsert search",
    "repair.kernel": "repair's partial pass and rounds as one launch of "
                     "kernel B5 (on the card)",
    "repair.validate": "repair's from-scratch validation of its lanes",
    "schedule.commit": "one schedule step's commit and its row of the matrix",
    "device.sync": "the host blocked on one device-to-host read (site attr)",
    # agent <-> service wire (service/agent.py)
    "wire.request": "full service round trip; server spans graft under it",
    "wire.transfer": "wire residual: round trip minus server-side spans",
    "wire.connect": "TCP connect for a fresh pooled socket (absent on reuse)",
    "wire.failover": "one FAILED endpoint attempt before failing over",
    # service-side spans, returned compactly in the PlanReply and
    # grafted by the agent (service/server.py)
    "service.admit": "inflight admission + request body read",
    "service.decode": "wire decode + contract checks of the request",
    "service.queue-wait": "time in the tenant queue before batch pop",
    "service.batch": "bucket padding + tenant stacking of the batch",
    "service.solve": "the batched device (or host-oracle) solve",
    "service.encode": "wire encode of the reply",
}

# hard per-trace span cap: a pathological tick (huge drain fan-out,
# retry storm) must bound its own observability cost; drops are counted
MAX_SPANS = 512


class Span:
    """One timed region. ``t0_ms`` is the offset from its scope's start
    (trace start for loop-side spans; request receipt / enqueue for
    server-returned spans — offsets are scope-local, not global)."""

    __slots__ = ("name", "t0_ms", "dur_ms", "attrs", "children")

    def __init__(self, name: str, t0_ms: float = 0.0, dur_ms: float = 0.0,
                 attrs: Optional[dict] = None):
        self.name = name
        self.t0_ms = t0_ms
        self.dur_ms = dur_ms
        self.attrs = attrs if attrs is not None else {}
        self.children: List[Span] = []

    def to_dict(self) -> dict:
        out = {
            "name": self.name,
            "t0_ms": round(self.t0_ms, 3),
            "dur_ms": round(self.dur_ms, 3),
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.children:
            out["spans"] = [c.to_dict() for c in self.children]
        return out


class Trace:
    """One tick's span tree. Single-threaded by design: spans open and
    close on the owning (loop) thread; worker threads hand back raw
    timestamps and the owner grafts them (service/agent.py)."""

    def __init__(self, trace_id: str = ""):
        self.trace_id = trace_id or new_trace_id()
        self.wall = time.time()
        self.attrs: Dict[str, object] = {}
        self.spans: List[Span] = []
        self.dropped = 0
        # the trace's start on time.perf_counter: every span's t0_ms is
        # its offset from here
        self.origin = time.perf_counter()
        self._stack: List[Span] = []
        self._n = 0

    # ------------------------------------------------------------------

    def _admit(self) -> bool:
        if self._n >= MAX_SPANS:
            self.dropped += 1
            return False
        self._n += 1
        return True

    def _attach(self, sp: Span) -> None:
        if self._stack:
            self._stack[-1].children.append(sp)
        else:
            self.spans.append(sp)

    @contextlib.contextmanager
    def span(self, name: str, **attrs):
        """One nested timed region; yields the Span (or None past the
        cap). A body that raises still records the span, with an
        ``error: true`` attribute, and re-raises. While a trace dir is
        set (``enable_profiler``) the span is also a
        ``torch.profiler.record_function`` range of the same name."""
        if not self._admit():
            yield None
            return
        rf = _profiler_range(name) if _trace_dir is not None else None
        if rf is not None:
            rf.__enter__()
        start = time.perf_counter()
        sp = Span(name, (start - self.origin) * 1e3, attrs=attrs or None)
        self._stack.append(sp)
        try:
            yield sp
        except BaseException:
            sp.attrs["error"] = True
            raise
        finally:
            sp.dur_ms = (time.perf_counter() - start) * 1e3
            self._stack.pop()
            self._attach(sp)
            if rf is not None:
                rf.__exit__(None, None, None)

    def graft(
        self,
        parent: Tuple[str, float, float],
        children: Iterable[Tuple[str, float, float]] = (),
        attrs: Optional[dict] = None,
    ) -> Optional[Span]:
        """Attach an already-measured span (plus flat children) at the
        current nesting level — how the agent folds the server-returned
        ``(name, t0_ms, dur_ms)`` tuples into the tick tree."""
        if not self._admit():
            return None
        sp = Span(parent[0], float(parent[1]), float(parent[2]),
                  attrs=dict(attrs) if attrs else None)
        for child in children:
            if not self._admit():
                break
            sp.children.append(
                Span(child[0], float(child[1]), float(child[2]))
            )
        self._attach(sp)
        return sp

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def find(self, name: str) -> List[Span]:
        """All spans with ``name``, depth-first (test/bench readback)."""
        out: List[Span] = []
        stack = list(self.spans)
        while stack:
            sp = stack.pop()
            if sp.name == name:
                out.append(sp)
            stack.extend(sp.children)
        return out

    def to_dict(self) -> dict:
        out = {
            "trace_id": self.trace_id,
            "wall": round(self.wall, 3),
            "spans": [s.to_dict() for s in self.spans],
        }
        if self.attrs:
            out["attrs"] = dict(self.attrs)
        if self.dropped:
            out["dropped_spans"] = self.dropped
        return out


def new_trace_id() -> str:
    """16 hex chars of OS entropy — unique across agents of a fleet
    (the service keys server-side spans by it)."""
    return os.urandom(8).hex()


# ---------------------------------------------------------------------------
# ambient (current-tick) trace

_ACTIVE = threading.local()


def start_trace(trace: Optional[Trace] = None) -> Trace:
    """Install ``trace`` (or a fresh one) as this thread's current
    trace; spans emitted via ``span(...)``/``phase(...)`` nest into it."""
    t = trace or Trace()
    _ACTIVE.trace = t
    return t


def end_trace(trace: Trace) -> None:
    if getattr(_ACTIVE, "trace", None) is trace:
        _ACTIVE.trace = None


def current_trace() -> Optional[Trace]:
    return getattr(_ACTIVE, "trace", None)


def current_trace_id() -> str:
    t = current_trace()
    return t.trace_id if t is not None else ""


@contextlib.contextmanager
def tick_trace(enabled: bool = True):
    """Scope one tick (or one standalone plan) under a fresh ambient
    trace; yields it (None when disabled)."""
    if not enabled:
        yield None
        return
    t = start_trace()
    try:
        yield t
    finally:
        end_trace(t)


@contextlib.contextmanager
def span(name: str, **attrs):
    """A span on the ambient trace — free (yields None) when no trace
    is active, so instrumented call sites cost one thread-local read
    on the untraced path."""
    t = current_trace()
    if t is None:
        yield None
        return
    with t.span(name, **attrs) as sp:
        yield sp


def make_span(name: str, t0_ms: float, dur_ms: float) -> Tuple[str, float, float]:
    """An already-measured ``(name, t0_ms, dur_ms)`` tuple — the compact
    form spans travel in over the service wire and graft back from."""
    return (name, float(t0_ms), float(dur_ms))


# ---------------------------------------------------------------------------
# phase timers + optional torch.profiler annotation

_trace_dir: Optional[str] = None
_trace_seq = [0]  # Chrome traces written by this process


def enable_profiler(trace_dir: str) -> None:
    """Annotate subsequent ``phase(...)`` blocks and spans for
    torch.profiler and let ``device_trace`` write its Chrome traces
    under ``trace_dir``."""
    global _trace_dir
    _trace_dir = trace_dir


def disable_profiler() -> None:
    global _trace_dir
    _trace_dir = None


def _profiler_range(name: str):
    """A ``torch.profiler.record_function`` range named ``name``, or None
    where torch.profiler is unavailable."""
    try:
        import torch.profiler

        return torch.profiler.record_function(name)
    except Exception as err:  # noqa: BLE001 — profiling is best-effort
        log.vlog(2, "profiler unavailable: %s", err)
        return None


@contextlib.contextmanager
def phase(name: str):
    """Time one tick phase into metrics (+ a span on the ambient trace,
    + a ``torch.profiler.record_function`` range while a trace dir is
    set). The duration is recorded even when the body raises — the span
    then carries ``error: true`` — so an error-skipped tick still
    explains where its time went."""
    start = time.perf_counter()
    t = current_trace()
    ctx = contextlib.nullcontext()
    if t is not None:
        ctx = t.span(name)  # the span opens the profiler range itself
    elif _trace_dir is not None:
        ctx = _profiler_range(name) or ctx
    try:
        with ctx:
            yield
    finally:
        metrics.observe_tick_phase(name, time.perf_counter() - start)


class DeviceTrace:
    """What ``device_trace`` yields: ``path`` is the Chrome trace it
    wrote, set when the region ends (None while it runs, when no trace
    dir is set, or when the profiler failed)."""

    def __init__(self) -> None:
        self.path: Optional[str] = None


@contextlib.contextmanager
def device_trace():
    """Wrap a region in a ``torch.profiler.profile`` (CPU activities,
    and CUDA's where a card is present) and write one Chrome trace per
    call under the trace dir. A no-op without ``enable_profiler``.

    The profiler is best-effort: a failure of torch.profiler itself is
    logged and the region runs untraced. An error raised by the region
    is never caught here; it reaches the caller (the trace of the
    region up to the error is still written)."""
    out = DeviceTrace()
    trace_dir = _trace_dir
    if trace_dir is None:
        yield out
        return
    prof = None
    try:
        import torch

        activities = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.__enter__()
    except Exception as err:  # noqa: BLE001 — profiling is best-effort
        log.vlog(2, "device trace failed to start: %s", err)
        prof = None
    try:
        yield out
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(trace_dir, exist_ok=True)
                _trace_seq[0] += 1
                path = os.path.join(
                    trace_dir,
                    f"torch_trace_{os.getpid()}_{_trace_seq[0]}.json",
                )
                prof.export_chrome_trace(path)
                out.path = path
            except Exception as err:  # noqa: BLE001 — profiling is best-effort; the region's own error (if any) still propagates
                log.vlog(2, "device trace failed: %s", err)
