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
        self._t0 = time.perf_counter()
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
        ``error: true`` attribute, and re-raises."""
        if not self._admit():
            yield None
            return
        start = time.perf_counter()
        sp = Span(name, (start - self._t0) * 1e3, attrs=attrs or None)
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
# phase timers (a profiler hook around them is a later slice)


@contextlib.contextmanager
def phase(name: str):
    """Time one tick phase into metrics (+ a span on the ambient trace).
    The duration is recorded even when the body raises — the span then
    carries ``error: true`` — so an error-skipped tick still explains
    where its time went."""
    start = time.perf_counter()
    t = current_trace()
    sctx = t.span(name) if t is not None else contextlib.nullcontext()
    try:
        with sctx:
            yield
    finally:
        metrics.observe_tick_phase(name, time.perf_counter() - start)
