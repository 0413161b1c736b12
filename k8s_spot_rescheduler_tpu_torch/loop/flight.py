"""Degradation flight recorder: the last N ticks, reconstructable.

The robustness machinery (planner fallback, circuit breaker, freshness
bypass, watch stalls, service load-shedding — PRs 4/6/8) fires counters,
but counters aggregate away the one thing a postmortem needs: the
*sequence* of decisions that led to a degraded tick. This module keeps
a bounded in-memory ring of the last N completed tick traces
(utils/tracing.py span trees) plus a structured event log of every
degradation decision — each event carrying its kind, cause and the
trace ID of the tick it fired in — and auto-dumps a redacted JSON
snapshot to ``flight_dump_dir`` whenever a *degradation edge* fires, so
every degraded tick is a self-contained postmortem file. Live
inspection: ``/debug/trace`` (last tick tree) and ``/debug/flight``
(ring summary + dump trigger) on the planner service's HTTP server
(``service/server.py``), gated by ``debug_endpoints``
(``--debug-endpoints``; off by default, and then both answer 404).

One module-level ``RECORDER`` because one controller (or one planner
service) runs per process — the same singleton convention as
loop/health.py; tests reset it via ``RECORDER.reset()``.

Redaction policy (docs/OBSERVABILITY.md): dumps and /debug responses
may leave the process, so cluster object identifiers must not travel
verbatim. Numeric/bool attribute values pass through; string attribute
values pass through only for the structural keys in ``SAFE_ATTR_KEYS``
(phase/reason/resource/solver/... vocabulary the code controls) — any
other string (node names, pod names, URL paths, tenant ids) is replaced
by an 8-hex SHA-1 tag, stable within a dump so correlation survives.
Event ``cause`` strings are kept (they are the postmortem) but
truncated to 200 characters.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from k8s_spot_rescheduler_tpu_torch.utils import logging as log

# Degradation edges: firing one of these (with a configured dump dir)
# writes a postmortem file. The non-degradation kinds below ride the
# event log for context but never trigger a dump.
DEGRADATION_KINDS = frozenset({
    "planner-fallback",        # contained planner crash -> numpy oracle
    "remote-planner-fallback",  # EVERY endpoint dead -> local oracle
    "breaker-engage",          # consecutive errors widened the interval
    "freshness-bypass",        # stale mirror -> direct-LIST observe
    "watch-stall",             # open-but-silent stream killed
    "service-shed",            # planner service 503 (inflight/queue/drain)
    "resync-shed",             # full-pack resync ingest refused (storm)
    "device-sick",             # watchdog flipped the service host-side
    "failover",                # served by a non-primary planner endpoint
    "schedule-invalidated",    # churn broke a drain-schedule prediction
    "delta-resync",            # delta base unusable -> full-pack resync
})
CONTEXT_KINDS = frozenset({
    "orphan-taint-recovered",
    "stale-mirror-plan-refused",
    "device-recovered",        # hysteresis probes passed; device resumes
    "twin-crash",              # contained fleet-twin pack/encode crash
})
EVENT_KINDS = DEGRADATION_KINDS | CONTEXT_KINDS

# structural attribute keys whose STRING values survive redaction —
# vocabulary the code itself emits, never cluster-derived identifiers
SAFE_ATTR_KEYS = frozenset({
    "phase", "reason", "resource", "solver", "outcome", "bucket",
    "method", "kind", "skipped", "source",
})
CAUSE_MAX_CHARS = 200

# at most one auto-dump per kind per window: a fault storm must produce
# a postmortem, not a disk-filling firehose (the ring itself still
# records every event)
DUMP_DEBOUNCE_S = 30.0

_EVENT_LOG_SIZE = 1024
# events held for the CURRENT tick entry, bounded: a process that never
# calls record_tick (a --serve service shedding load, a controller with
# trace_enabled off) must not leak one dict per degradation event
# forever — past the cap the oldest open events fall off (the global
# _events log and the per-kind counts still see every one)
_OPEN_EVENTS_MAX = 256


def redact_text(value: str) -> str:
    """The one identifier-redaction primitive (docs/OBSERVABILITY.md):
    an 8-hex SHA-1 tag, stable within a process so correlation across
    spans/events survives redaction."""
    return "sha1:" + hashlib.sha1(value.encode("utf-8")).hexdigest()[:8]


def _redact_attrs(attrs: dict) -> dict:
    out = {}
    for key, value in attrs.items():
        if isinstance(value, str) and key not in SAFE_ATTR_KEYS:
            out[key] = redact_text(value)
        else:
            out[key] = value
    return out


def _redact_span(span: dict) -> dict:
    out = dict(span)
    if "attrs" in out:
        out["attrs"] = _redact_attrs(out["attrs"])
    if "spans" in out:
        out["spans"] = [_redact_span(s) for s in out["spans"]]
    return out


def _redact_trace(trace: dict) -> dict:
    out = dict(trace)
    if "attrs" in out:
        out["attrs"] = _redact_attrs(out["attrs"])
    out["spans"] = [_redact_span(s) for s in trace.get("spans", ())]
    return out


def _redact_event(event: dict) -> dict:
    out = dict(event)
    if "attrs" in out:
        out["attrs"] = _redact_attrs(out["attrs"])
    return out


def _write_dump(payload: dict, count: int, dump_dir: str) -> Optional[str]:
    """Serialize + write one already-snapshotted postmortem. Runs
    OUTSIDE the recorder lock — a slow or throttled disk must not stall
    the tick/watcher/HTTP threads queued on note_event at exactly the
    degraded moment the recorder exists for."""
    try:
        os.makedirs(dump_dir, exist_ok=True)
        path = os.path.join(
            dump_dir,
            "flight_%d_%03d_%s.json"
            % (int(time.time() * 1e3), count, payload.get("reason", "")),
        )
        with open(path, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        return path
    except OSError as err:
        # a full/readonly disk must not take the control loop down with
        # it — the ring keeps recording in memory
        log.error("flight recorder dump failed: %s", err)
        return None


class FlightRecorder:
    def __init__(self, ring_size: int = 64, dump_dir: str = ""):
        self._lock = threading.Lock()
        self._ring_size = max(1, int(ring_size))
        self._dump_dir = str(dump_dir or "")
        self._ticks: deque = deque(maxlen=self._ring_size)
        self._events: deque = deque(maxlen=_EVENT_LOG_SIZE)
        # since the last record_tick (bounded: see _OPEN_EVENTS_MAX)
        self._open_events: deque = deque(maxlen=_OPEN_EVENTS_MAX)
        self._counts: Dict[str, int] = {}
        self._dump_count = 0
        self._last_dump_wall: Dict[str, float] = {}
        self._seq = 0

    # ------------------------------------------------------------------
    # configuration / lifecycle

    def configure(
        self,
        ring_size: Optional[int] = None,
        dump_dir: Optional[str] = None,
    ) -> None:
        """(Re)apply config knobs; recorded history is preserved (the
        controller and the service server both configure on startup)."""
        with self._lock:
            if ring_size is not None and int(ring_size) >= 1 \
                    and int(ring_size) != self._ring_size:
                self._ring_size = int(ring_size)
                self._ticks = deque(self._ticks, maxlen=self._ring_size)
            if dump_dir is not None:
                self._dump_dir = str(dump_dir)

    def reset(self) -> None:
        """Back to process-start state (test isolation); keeps the
        configured sizes/dir."""
        with self._lock:
            self._ticks.clear()
            self._events.clear()
            self._open_events.clear()
            self._counts = {}
            self._dump_count = 0
            self._last_dump_wall = {}
            self._seq = 0

    # ------------------------------------------------------------------
    # recording

    def note_event(
        self, kind: str, cause: str = "", trace_id: str = "", **attrs
    ) -> dict:
        """One structured degradation/decision event. Degradation kinds
        auto-dump a redacted postmortem when a dump dir is configured
        (debounced per kind). Returns the event record."""
        event = {
            "kind": kind,
            "cause": str(cause)[:CAUSE_MAX_CHARS],
            "trace_id": trace_id,
            "wall": round(time.time(), 3),
        }
        if attrs:
            event["attrs"] = attrs
        pending = None
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            self._events.append(event)
            self._open_events.append(event)
            self._counts[kind] = self._counts.get(kind, 0) + 1
            if kind in DEGRADATION_KINDS and self._dump_dir:
                now = time.time()
                last = self._last_dump_wall.get(kind)
                if last is None or now - last >= DUMP_DEBOUNCE_S:
                    self._last_dump_wall[kind] = now
                    self._dump_count += 1
                    pending = (
                        self._payload_locked(kind),
                        self._dump_count,
                        self._dump_dir,
                    )
        if pending is not None:
            # serialize + write OUTSIDE the lock: a slow/throttled disk
            # must stall neither the tick thread nor the watcher/HTTP
            # threads queued on note_event at exactly the degraded
            # moment the recorder exists for
            dump_path = _write_dump(*pending)
            if dump_path:
                log.vlog(
                    2, "flight recorder: %s fired; dumped %s",
                    kind, dump_path,
                )
        return event

    def record_tick(self, trace: dict, **attrs) -> None:
        """One completed tick: its trace dict plus the decision events
        that fired during it become one ring entry."""
        with self._lock:
            entry = {"trace": trace, "events": list(self._open_events)}
            if attrs:
                entry["attrs"] = attrs
            self._open_events.clear()
            self._ticks.append(entry)

    # ------------------------------------------------------------------
    # readback

    def counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Unredacted event records (in-process readback for tests and
        the soak harnesses; external surfaces go through snapshot())."""
        with self._lock:
            out = [dict(e) for e in self._events]
        if kind is not None:
            out = [e for e in out if e["kind"] == kind]
        return out

    def attr_counts(self, kind: str, key: str) -> Dict[str, int]:
        """Events of ``kind`` grouped by a SAFE attr (e.g. service-shed
        by ``reason``): the per-label readback the fleet-twin smoke
        diffs against the labeled metric so flight-delta == metric-delta
        holds per reason, not just in total. Bounded by the event log
        (the per-kind totals in counts() see every event; this sees the
        retained window — diff over a window shorter than the log)."""
        out: Dict[str, int] = {}
        with self._lock:
            for event in self._events:
                if event["kind"] != kind:
                    continue
                value = str(event.get("attrs", {}).get(key, ""))
                out[value] = out.get(value, 0) + 1
        return out

    def last_tick(self) -> Optional[dict]:
        """The most recent ring entry, redacted (/debug/trace)."""
        with self._lock:
            if not self._ticks:
                return None
            entry = self._ticks[-1]
        return {
            "trace": _redact_trace(entry["trace"]),
            "events": [_redact_event(e) for e in entry["events"]],
            **({"attrs": entry["attrs"]} if "attrs" in entry else {}),
        }

    def snapshot(self) -> dict:
        """Redacted ring summary (/debug/flight): counts per kind, ring
        occupancy, the most recent events, dump bookkeeping."""
        with self._lock:
            return {
                "ring_ticks": len(self._ticks),
                "ring_size": self._ring_size,
                "event_counts": dict(self._counts),
                "events": [
                    _redact_event(e) for e in list(self._events)[-32:]
                ],
                "dumps_written": self._dump_count,
                "dump_dir_configured": bool(self._dump_dir),
            }

    def dump_count(self) -> int:
        with self._lock:
            return self._dump_count

    # ------------------------------------------------------------------
    # dumping

    def dump(self, reason: str) -> Optional[str]:
        """Write a redacted postmortem of the whole ring; returns the
        file path (None without a configured dump dir). The snapshot is
        taken under the lock; the file write happens outside it."""
        with self._lock:
            if not self._dump_dir:
                return None
            self._dump_count += 1
            pending = (
                self._payload_locked(reason),
                self._dump_count,
                self._dump_dir,
            )
        return _write_dump(*pending)

    def _payload_locked(self, reason: str) -> dict:
        """The redacted dump payload, snapshotted while the caller
        holds the lock (the deques must not mutate mid-iteration)."""
        return {
            "reason": reason,
            "wall": round(time.time(), 3),
            "event_counts": dict(self._counts),
            "events": [_redact_event(e) for e in self._events],
            "ring": [
                {
                    "trace": _redact_trace(entry["trace"]),
                    "events": [_redact_event(e) for e in entry["events"]],
                }
                for entry in self._ticks
            ],
        }


RECORDER = FlightRecorder()


def configure(ring_size: Optional[int] = None,
              dump_dir: Optional[str] = None) -> None:
    RECORDER.configure(ring_size=ring_size, dump_dir=dump_dir)


def note_event(kind: str, cause: str = "", trace_id: str = "", **attrs) -> dict:
    return RECORDER.note_event(kind, cause=cause, trace_id=trace_id, **attrs)


def record_tick(trace: dict, **attrs) -> None:
    RECORDER.record_tick(trace, **attrs)


def counts() -> Dict[str, int]:
    return RECORDER.counts()


def attr_counts(kind: str, key: str) -> Dict[str, int]:
    return RECORDER.attr_counts(kind, key)


def events(kind: Optional[str] = None) -> List[dict]:
    return RECORDER.events(kind)


def snapshot() -> dict:
    return RECORDER.snapshot()


def last_tick() -> Optional[dict]:
    return RECORDER.last_tick()


def dump(reason: str) -> Optional[str]:
    return RECORDER.dump(reason)
