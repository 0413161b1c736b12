"""Checked protocol model: the wire/breaker/resync automata as data.

The port's copy of the service protocol model. The port speaks the
same wire bytes, runs the same per-endpoint breaker and the same
resync-ingest admission class as the JAX package, so its model holds
the same tables and the same automata; only the code it is bound to
differs: this package's ``service/wire.py``, ``service/agent.py`` and
``service/server.py``.

Everything the service protocol promises — wire version negotiation,
the delta/fingerprint/RESYNC ladder, the per-endpoint breaker, the
resync-ingest admission class — is declared here twice over:

1. **Declarative tables** (``KINDS``, ``SHED_REASONS``,
   ``BREAKER_TABLE``, ``BREAKER_CONSTANTS``, ``ADMISSION_*``,
   ``LADDER_TABLE``): the protocol surface as plain data, each entry
   bound to a live code site (``"service/agent.py::RemotePlanner.
   _note_failure"``). The proto-tier ``protocol-contract`` pass
   (tools/analysis/proto/contract.py) holds these tables and the
   implementation in lockstep in BOTH directions — a ``KIND_*``
   constant, ``_note_shed`` reason, breaker constant, admission
   counter or ``_Endpoint.__slots__`` field added to the code without
   a model entry turns the check red, and so does a model entry whose
   code site was deleted. The model cannot drift the way a design doc
   would. Check this package's copy with::

       python -m tools.analysis --tier proto k8s_spot_rescheduler_tpu_torch

   and ``tests/test_torch_protocol_model.py`` (the tables value by
   value against the JAX package's model, the explored sizes, and
   seeded drift in copies of this package's service modules).

2. **An executable product automaton** (``build_systems``): N agents x
   M replicas with per-agent request/reply channels (loss and
   retry-after-lost-reply duplication), replica restart events, churn,
   and the admission token bucket + byte ledger, explored EXHAUSTIVELY
   by the proto-tier checker (tools/analysis/proto/model_check.py).
   The checker proves, over every reachable state:

   - safety: no double full-pack admission per (tenant,
     restart-epoch); no delta applied over a mismatched fingerprint;
     admission inflight <= cap; no frame decoded below its minimum
     wire version (version-mix run);
   - liveness: from EVERY reachable state the drained goal state (all
     tenants cached + acked, all breakers closed, channels quiet) is
     reachable, and no non-goal state is terminal — under weak
     fairness on admission releases and breaker-backoff expiry the
     storm therefore drains, and no breaker livelocks against a
     healthy replica.

Deliberately dependency-free: this module imports NOTHING from
``service/wire.py`` / ``service/agent.py`` / ``service/server.py``.
If it did, the contract checks would be vacuously true; because it
does not, every mirrored constant below is a falsifiable claim.

Modeling notes (docs/ANALYSIS.md "Protocol tier"):

- Time is abstracted away: backoff/Retry-After horizons become
  nondeterministic ``expire`` events; the 30 s Retry-After cap and the
  jitter factors are carried as symbolic intervals
  (``RETRY_AFTER_INTERVAL_S``, ``RESYNC_RETRY_DELAY_INTERVAL_S``) and
  contract-checked against the live constants, not explored.
- Channels are request/reply slots (one outstanding request per
  agent, as the real single-threaded-per-agent HTTP RPC guarantees);
  reorder is interleaving across agents, duplication is the real
  form it takes over TCP — an agent retrying after a LOST REPLY
  re-delivers a request the server already processed.
- The byte ledger is modeled in abstract units (``pack_units``); the
  idle floor (a lone over-budget tenant is admitted when the class is
  idle) is exercised by giving one agent a pack larger than the whole
  budget.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

# =====================================================================
# 1. Declarative tables — the contract-checked protocol surface
# =====================================================================

# --- wire versions (service/wire.py) ---------------------------------

VERSIONS = (1, 2, 3, 4)  # == wire.SUPPORTED_VERSIONS
WIRE_VERSION = 4  # == wire.WIRE_VERSION; replies mirror the REQUEST's
#                   version (never the server's newer one)


@dataclasses.dataclass(frozen=True)
class FrameKind:
    """One wire frame kind: its constant value, the minimum version
    whose decoder accepts it (pre-vN frames are REFUSED at decode,
    wire.WireVersionError), and the live encode site."""

    value: int
    min_version: int
    direction: str  # "agent->server" | "server->agent"
    site: str  # "path::qualname" of the encoding function


KINDS = {
    "KIND_PLAN_REQUEST": FrameKind(
        1, 1, "agent->server", "service/wire.py::encode_plan_request"),
    "KIND_PLAN_REPLY": FrameKind(
        2, 1, "server->agent", "service/wire.py::encode_plan_reply"),
    "KIND_PACKED_DELTA": FrameKind(
        3, 4, "agent->server", "service/wire.py::encode_packed_delta"),
    "KIND_ERROR": FrameKind(
        4, 1, "server->agent", "service/wire.py::encode_error"),
    "KIND_PLAN_SCHEDULE": FrameKind(
        5, 3, "server->agent",
        "service/wire.py::encode_plan_schedule_reply"),
    "KIND_RESYNC": FrameKind(
        6, 4, "server->agent", "service/wire.py::encode_resync"),
}

# --- admission-shed reasons (service/server.py _note_shed funnel) ----


@dataclasses.dataclass(frozen=True)
class ShedReason:
    """One labeled 503 reason: the flight-recorder kind it pairs with
    (one site per reason, flight delta == metric delta) and the live
    ``_note_shed`` call site."""

    flight_kind: str  # "service-shed" | "resync-shed"
    site: str


SHED_REASONS = {
    "deadline": ShedReason(
        "service-shed",
        "service/server.py::PlannerService._finish_wait"),
    "queue-timeout": ShedReason(
        "service-shed",
        "service/server.py::PlannerService._finish_wait"),
    "drain-evict": ShedReason(
        "service-shed",
        "service/server.py::PlannerService.drain_pending"),
    "drain-refuse": ShedReason(
        "service-shed",
        "service/server.py::ServiceServer.__init__.Handler._read_body"),
    "max-inflight": ShedReason(
        "service-shed",
        "service/server.py::ServiceServer.__init__.Handler._read_body"),
    "resync-storm": ShedReason(
        "resync-shed",
        "service/server.py::ServiceServer.__init__.Handler._post_wire"),
}

# --- per-endpoint breaker (service/agent.py RemotePlanner) -----------

BREAKER_STATES = ("closed", "open", "half-open")


@dataclasses.dataclass(frozen=True)
class BreakerEdge:
    src: str
    dst: str
    event: str
    site: str


BREAKER_TABLE = (
    BreakerEdge("closed", "closed", "failure-below-threshold",
                "service/agent.py::RemotePlanner._note_failure"),
    BreakerEdge("closed", "open", "failure-at-threshold",
                "service/agent.py::RemotePlanner._note_failure"),
    BreakerEdge("closed", "closed", "success",
                "service/agent.py::RemotePlanner._note_success"),
    BreakerEdge("open", "half-open", "backoff-expired",
                "service/agent.py::RemotePlanner._ladder_call"),
    BreakerEdge("half-open", "closed", "probe-success",
                "service/agent.py::RemotePlanner._note_success"),
    BreakerEdge("half-open", "open", "probe-failure",
                "service/agent.py::RemotePlanner._note_failure"),
)

# Mirrors of RemotePlanner's numeric class constants — every UPPERCASE
# numeric attribute on the class must appear here with this exact
# value, and vice versa (protocol-contract, both directions).
BREAKER_CONSTANTS = {
    "FAIL_THRESHOLD": 2,
    "BACKOFF_BASE": 5.0,
    "BACKOFF_MAX": 120.0,
    "RETRY_AFTER_CAP_S": 30.0,
    "RETRY_JITTER_FRAC": 0.5,
    "RESYNC_JITTER_S": 2.0,
}

# == agent._Endpoint.__slots__ (public name agent.Endpoint) — the
# whole per-endpoint state the breaker/ladder automaton runs on; a
# new field means a new model dimension and must land here first.
ENDPOINT_FIELDS = ("url", "consecutive_failures", "skip_until",
                   "acked_fp")

# Symbolic jitter intervals (NOT explored — time is abstract; the
# contract pins the endpoints to the live constants):
# a 503's suggested horizon is clamped to [0, RETRY_AFTER_CAP_S] then
# scaled by uniform[1, 1 + RETRY_JITTER_FRAC)
RETRY_AFTER_INTERVAL_S = (0.0, 30.0 * (1.0 + 0.5))
# the one full-pack resync retry waits uniform[0, RESYNC_JITTER_S]
# (clamped to half the remaining deadline)
RESYNC_RETRY_DELAY_INTERVAL_S = (0.0, 2.0)

# --- resync-ingest admission (service/server.py ServiceServer) -------

ADMISSION_CAP_ATTR = "resync_ingest_cap"
ADMISSION_LOCK_ATTR = "_resync_lock"
ADMISSION_COUNTERS = (
    "_resync_inflight", "_resync_ledger_bytes", "_resync_pressure",
)
ADMISSION_SITES = {
    "admit": "service/server.py::ServiceServer.admit_resync_ingest",
    "release": "service/server.py::ServiceServer.release_resync_ingest",
}

# --- the delta/fingerprint/RESYNC ladder (events -> live sites) ------


@dataclasses.dataclass(frozen=True)
class LadderEvent:
    event: str
    site: str


LADDER_TABLE = (
    # ship a delta only to an endpoint whose acked_fp matches the base
    LadderEvent("send-delta",
                "service/agent.py::RemotePlanner._ladder_call"),
    LadderEvent("send-full-pack",
                "service/agent.py::RemotePlanner._ladder_call"),
    # server refuses the delta base (uncached / restarted / mismatch)
    LadderEvent("resync-demand",
                "service/server.py::PlannerService.note_resync"),
    # the agent's one jittered full-pack retry on the SAME endpoint
    LadderEvent("full-pack-retry",
                "service/agent.py::RemotePlanner._resync_retry_delay"),
    # success advances the endpoint's acked_fp to the shipped pack
    LadderEvent("ack-fingerprint",
                "service/agent.py::RemotePlanner._ladder_call"),
    # a replica restart is observed as a cache mismatch server-side
    LadderEvent("replica-restart",
                "service/server.py::PlannerService._cache_mismatch_locked"),
    # every endpoint dead/skipped -> the local numpy oracle
    LadderEvent("fallback-local",
                "service/agent.py::RemotePlanner._plan_fallback"),
)


# =====================================================================
# 2. The executable product automaton
# =====================================================================

# agent phase tags
_IDLE = "idle"
_WAIT = "wait"  # request in flight / processing / reply in flight
_RESYNC = "resync"  # RESYNC received; full-pack retry pending

# request kinds in the explored subset
_DELTA = "delta"
_FULL = "full"

# channel stages for a _WAIT phase
_ST_REQ = "req"  # request frame in flight toward the replica
_ST_PROC = "proc"  # admitted resync-class ingest being processed
_ST_PLAN = "plan"  # PLAN_REPLY in flight back
_ST_RESYNC = "rsync"  # KIND_RESYNC demand in flight back
_ST_SHED = "shed"  # typed 503 (resync-storm) in flight back
_ST_LOST = "lost"  # frame dropped; the agent will time out

_CLOSED, _OPEN, _HALF = "closed", "open", "half-open"

_NO_FP = -1  # "no fingerprint": nothing acked / nothing cached


@dataclasses.dataclass(frozen=True)
class ModelBounds:
    """Exploration bounds for one product-automaton run. The defaults
    are the declared proof bounds (docs/ANALYSIS.md): >= 2 agents
    x 2 replicas with a restart event."""

    name: str = "storm"
    n_agents: int = 2
    n_replicas: int = 2
    # wire version each agent negotiates (replies mirror it)
    versions: Tuple[int, ...] = (4, 4)
    # churn events (pack-fingerprint bumps) available per agent
    churn_budget: Tuple[int, ...] = (1, 0)
    # abstract byte-ledger units per agent's full pack
    pack_units: Tuple[int, ...] = (1, 3)
    loss_budget: int = 1
    restart_budget: int = 1
    # admission class: token bucket + byte ledger (abstract units)
    ingest_cap: int = 2
    ingest_budget_units: int = 2
    pressure_max: int = 1


# The two checked configurations: the resync-storm run (both agents on
# the current wire, churn + restart + loss) and the version-mix run
# (a v4 agent beside a v3 agent; proves no frame is ever decoded below
# its minimum version while the fleet is mixed).
CHECK_BOUNDS = (
    ModelBounds(),
    ModelBounds(
        name="version-mix",
        versions=(4, 3),
        churn_budget=(1, 0),
        pack_units=(1, 1),
        ingest_cap=1,
        ingest_budget_units=2,
    ),
)


def _initial_agent(bounds: ModelBounds) -> tuple:
    eps = tuple((_NO_FP, 0, _CLOSED) for _ in range(bounds.n_replicas))
    return ((_IDLE,), 0, eps)


def _initial_replica(bounds: ModelBounds) -> tuple:
    cached = tuple(_NO_FP for _ in range(bounds.n_agents))
    bits = tuple(0 for _ in range(bounds.n_agents))
    return (0, cached, bits, (), 0)


class ProtocolSystem:
    """One bounded product automaton over the tables above.

    State (all nested tuples, hashable):
      ``(agents, replicas, budgets)``
      agent   = (phase, fp, endpoints)
                phase = ("idle",) | ("wait", r, kind, stage)
                      | ("resync", r)
                endpoints[r] = (acked_fp, failures, breaker_state)
      replica = (epoch, cached_by_agent, fullpack_bits, proc, pressure)
      budgets = (churn_by_agent, loss, restarts)
    """

    def __init__(self, bounds: ModelBounds):
        self.bounds = bounds
        self.name = bounds.name

    # -- construction --------------------------------------------------

    def initial(self) -> tuple:
        b = self.bounds
        agents = tuple(_initial_agent(b) for _ in range(b.n_agents))
        replicas = tuple(
            _initial_replica(b) for _ in range(b.n_replicas)
        )
        budgets = (tuple(b.churn_budget), b.loss_budget,
                   b.restart_budget)
        return (agents, replicas, budgets)

    # -- small pure helpers -------------------------------------------

    @staticmethod
    def _with_agent(state, a, agent):
        agents, replicas, budgets = state
        agents = agents[:a] + (agent,) + agents[a + 1:]
        return (agents, replicas, budgets)

    @staticmethod
    def _with_replica(state, r, replica):
        agents, replicas, budgets = state
        replicas = replicas[:r] + (replica,) + replicas[r + 1:]
        return (agents, replicas, budgets)

    @staticmethod
    def _with_budgets(state, budgets):
        agents, replicas, _ = state
        return (agents, replicas, budgets)

    def _note_failure(self, ep: tuple) -> tuple:
        """BREAKER_TABLE: failure-below-threshold / failure-at-threshold
        / probe-failure."""
        acked, fails, brk = ep
        fails = min(fails + 1, BREAKER_CONSTANTS["FAIL_THRESHOLD"])
        if fails >= BREAKER_CONSTANTS["FAIL_THRESHOLD"]:
            return (acked, fails, _OPEN)
        return (acked, fails, _CLOSED)

    @staticmethod
    def _note_success(ep: tuple, acked_fp: Optional[int]) -> tuple:
        """BREAKER_TABLE: success / probe-success; LADDER_TABLE:
        ack-fingerprint (acked_fp advances only when the reply carried
        a fingerprint — v4)."""
        acked, _, _ = ep
        if acked_fp is not None:
            acked = acked_fp
        return (acked, 0, _CLOSED)

    def _ladder_target(self, eps: tuple) -> Optional[int]:
        """The real ladder walks endpoints in order, skipping open
        breakers; half-open endpoints take a probe."""
        for r, (_, _, brk) in enumerate(eps):
            if brk != _OPEN:
                return r
        return None

    # -- transition relation ------------------------------------------

    def successors(
        self, state: tuple
    ) -> Iterator[Tuple[str, dict, tuple]]:
        """Yield (label, info, next_state). ``info`` feeds the safety
        checks (model_check) and is never part of the state."""
        b = self.bounds
        agents, replicas, budgets = state
        churn, loss, restarts = budgets

        for a, agent in enumerate(agents):
            phase, fp, eps = agent
            version = b.versions[a]

            if phase[0] == _IDLE:
                # churn: the tenant's pack fingerprint advances
                if churn[a] > 0:
                    nb = (
                        churn[:a] + (churn[a] - 1,) + churn[a + 1:],
                        loss, restarts,
                    )
                    yield (
                        f"churn[a{a}]", {},
                        self._with_budgets(
                            self._with_agent(
                                state, a, (phase, fp + 1, eps)
                            ),
                            nb,
                        ),
                    )
                # tick: send through the endpoint ladder
                r = self._ladder_target(eps)
                if r is not None:
                    acked = eps[r][0]
                    if version >= 4 and acked != _NO_FP:
                        kind = _DELTA  # LADDER: send-delta
                    else:
                        kind = _FULL  # LADDER: send-full-pack
                    nphase = (_WAIT, r, kind, _ST_REQ)
                    yield (
                        f"send-{kind}[a{a}->r{r}]",
                        {"event": "send", "agent": a, "version": version,
                         "kind": ("KIND_PACKED_DELTA" if kind == _DELTA
                                  else "KIND_PLAN_REQUEST")},
                        self._with_agent(state, a, (nphase, fp, eps)),
                    )
                continue

            if phase[0] == _RESYNC:
                # LADDER: full-pack-retry on the SAME endpoint, no
                # breaker penalty for the demand itself
                r = phase[1]
                nphase = (_WAIT, r, _FULL, _ST_REQ)
                yield (
                    f"full-pack-retry[a{a}->r{r}]",
                    {"event": "send", "agent": a, "version": version,
                     "kind": "KIND_PLAN_REQUEST"},
                    self._with_agent(state, a, (nphase, fp, eps)),
                )
                continue

            _, r, kind, stage = phase
            replica = replicas[r]
            epoch, cached, bits, proc, pressure = replica

            if stage == _ST_REQ:
                if loss > 0:
                    yield (
                        f"lose-req[a{a}]", {},
                        self._with_budgets(
                            self._with_agent(
                                state, a,
                                ((_WAIT, r, kind, _ST_LOST), fp, eps),
                            ),
                            (churn, loss - 1, restarts),
                        ),
                    )
                yield from self._deliver(state, a, r)

            elif stage == _ST_PROC:
                # admitted resync-class ingest completes: cache seeded,
                # admission charge released, pressure relaxes
                ncached = cached[:a] + (fp,) + cached[a + 1:]
                nproc = tuple(x for x in proc if x != a)
                nrep = (epoch, ncached, bits, nproc,
                        max(0, pressure - 1))
                yield (
                    f"ingest-complete[a{a}@r{r}]",
                    {"event": "reply", "agent": a,
                     "version": self.bounds.versions[a],
                     "kind": "KIND_PLAN_REPLY"},
                    self._with_replica(
                        self._with_agent(
                            state, a,
                            ((_WAIT, r, kind, _ST_PLAN), fp, eps),
                        ),
                        r, nrep,
                    ),
                )

            elif stage in (_ST_PLAN, _ST_RESYNC, _ST_SHED):
                if loss > 0:
                    yield (
                        f"lose-reply[a{a}]", {},
                        self._with_budgets(
                            self._with_agent(
                                state, a,
                                ((_WAIT, r, kind, _ST_LOST), fp, eps),
                            ),
                            (churn, loss - 1, restarts),
                        ),
                    )
                yield from self._receive(state, a, r, stage)

            elif stage == _ST_LOST:
                # the agent's deadline fires: breaker notes a failure
                nep = self._note_failure(eps[r])
                neps = eps[:r] + (nep,) + eps[r + 1:]
                yield (
                    f"timeout[a{a}@r{r}]", {},
                    self._with_agent(state, a, ((_IDLE,), fp, neps)),
                )

        # breaker backoff expiry: open -> half-open (untimed)
        for a, agent in enumerate(agents):
            phase, fp, eps = agent
            for r, ep in enumerate(eps):
                if ep[2] == _OPEN:
                    nep = (ep[0], ep[1], _HALF)
                    neps = eps[:r] + (nep,) + eps[r + 1:]
                    yield (
                        f"backoff-expired[a{a}@r{r}]", {},
                        self._with_agent(state, a, (phase, fp, neps)),
                    )

        # replica restart: warm restart wipes the tenant cache and the
        # admission class; in-flight exchanges with it die
        if restarts > 0:
            for r in range(b.n_replicas):
                epoch = replicas[r][0]
                nrep = (
                    epoch + 1,
                    tuple(_NO_FP for _ in range(b.n_agents)),
                    tuple(0 for _ in range(b.n_agents)),
                    (), 0,
                )
                nstate = self._with_replica(state, r, nrep)
                for a, agent in enumerate(agents):
                    phase, fp, eps = agent
                    if phase[0] == _WAIT and phase[1] == r:
                        nphase = (_WAIT, r, phase[2], _ST_LOST)
                        nstate = self._with_agent(
                            nstate, a, (nphase, fp, eps)
                        )
                nstate = self._with_budgets(
                    nstate, (churn, loss, restarts - 1)
                )
                yield (f"restart[r{r}]", {"event": "restart",
                                          "replica": r}, nstate)

    def _deliver(
        self, state: tuple, a: int, r: int
    ) -> Iterator[Tuple[str, dict, tuple]]:
        """The replica processes agent ``a``'s in-flight request."""
        b = self.bounds
        agents, replicas, _ = state
        phase, fp, eps = agents[a]
        _, _, kind, _ = phase
        epoch, cached, bits, proc, pressure = replicas[r]
        version = b.versions[a]
        acked = eps[r][0]

        if kind == _DELTA:
            # base fingerprint the delta was computed against == the
            # endpoint's acked_fp at send time (unchanged while waiting)
            base = acked
            if cached[a] == base and base != _NO_FP:
                ncached = cached[:a] + (fp,) + cached[a + 1:]
                nrep = (epoch, ncached, bits, proc, pressure)
                yield (
                    f"apply-delta[a{a}@r{r}]",
                    {"event": "apply-delta", "agent": a, "replica": r,
                     "base": base, "cached": cached[a],
                     "version": version, "kind": "KIND_PLAN_REPLY"},
                    self._with_replica(
                        self._with_agent(
                            state, a,
                            ((_WAIT, r, _DELTA, _ST_PLAN), fp, eps),
                        ),
                        r, nrep,
                    ),
                )
            else:
                # LADDER: resync-demand (uncached / restart / mismatch)
                yield (
                    f"resync-demand[a{a}@r{r}]",
                    {"event": "reply", "agent": a, "version": version,
                     "kind": "KIND_RESYNC"},
                    self._with_agent(
                        state, a,
                        ((_WAIT, r, _DELTA, _ST_RESYNC), fp, eps),
                    ),
                )
            return

        # full pack
        if version < 4:
            # unfingerprinted pack: served statelessly, never cached,
            # never admission-gated; the reply mirrors the old version
            yield (
                f"plan-v{version}[a{a}@r{r}]",
                {"event": "reply", "agent": a, "version": version,
                 "kind": "KIND_PLAN_REPLY"},
                self._with_agent(
                    state, a, ((_WAIT, r, _FULL, _ST_PLAN), fp, eps)
                ),
            )
            return

        if cached[a] != _NO_FP:
            # warm tenant re-uploading (e.g. duplicate after a lost
            # reply, or a fingerprint-mismatch retry): idempotent
            # re-cache, NOT a resync-class ingest
            ncached = cached[:a] + (fp,) + cached[a + 1:]
            nrep = (epoch, ncached, bits, proc, pressure)
            yield (
                f"recache[a{a}@r{r}]",
                {"event": "reply", "agent": a, "version": version,
                 "kind": "KIND_PLAN_REPLY"},
                self._with_replica(
                    self._with_agent(
                        state, a,
                        ((_WAIT, r, _FULL, _ST_PLAN), fp, eps),
                    ),
                    r, nrep,
                ),
            )
            return

        # uncached + fingerprinted: the resync-storm admission class
        # (ADMISSION_SITES["admit"])
        ledger = sum(b.pack_units[x] for x in proc)
        per = b.pack_units[a]
        over_cap = len(proc) >= b.ingest_cap
        over_budget = (
            len(proc) > 0 and ledger + per > b.ingest_budget_units
        )  # idle floor: a lone over-budget tenant is admitted
        if over_cap or over_budget:
            yield (
                f"shed-resync[a{a}@r{r}]",
                {"event": "reply", "agent": a, "version": version,
                 "kind": "KIND_ERROR", "shed_reason": "resync-storm"},
                self._with_replica(
                    self._with_agent(
                        state, a,
                        ((_WAIT, r, _FULL, _ST_SHED), fp, eps),
                    ),
                    r,
                    (epoch, cached, bits, proc,
                     min(pressure + 1, b.pressure_max)),
                ),
            )
            return
        nbits = bits[:a] + (1,) + bits[a + 1:]
        nproc = tuple(sorted(proc + (a,)))
        yield (
            f"admit-full-pack[a{a}@r{r}]",
            {"event": "admit-full-pack", "agent": a, "replica": r,
             "epoch": epoch, "bit": bits[a]},
            self._with_replica(
                self._with_agent(
                    state, a, ((_WAIT, r, _FULL, _ST_PROC), fp, eps)
                ),
                r, (epoch, cached, nbits, nproc, pressure),
            ),
        )

    def _receive(
        self, state: tuple, a: int, r: int, stage: str
    ) -> Iterator[Tuple[str, dict, tuple]]:
        """The agent consumes the in-flight reply."""
        agents, _, _ = state
        phase, fp, eps = agents[a]
        version = self.bounds.versions[a]

        if stage == _ST_PLAN:
            # v4 replies ack the shipped pack's fingerprint; pre-v4
            # replies carry none (acked_fp stays empty)
            acked_fp = fp if version >= 4 else None
            nep = self._note_success(eps[r], acked_fp)
            neps = eps[:r] + (nep,) + eps[r + 1:]
            yield (
                f"recv-plan[a{a}]", {},
                self._with_agent(state, a, ((_IDLE,), fp, neps)),
            )
        elif stage == _ST_RESYNC:
            # RESYNC demand: the acked fingerprint is void; retry a
            # full pack on the same endpoint (no breaker penalty)
            nep = (_NO_FP, eps[r][1], eps[r][2])
            neps = eps[:r] + (nep,) + eps[r + 1:]
            yield (
                f"recv-resync[a{a}]", {},
                self._with_agent(state, a, ((_RESYNC, r), fp, neps)),
            )
        else:  # _ST_SHED — typed 503, Retry-After honored via breaker
            nep = self._note_failure(eps[r])
            neps = eps[:r] + (nep,) + eps[r + 1:]
            yield (
                f"recv-shed[a{a}]", {},
                self._with_agent(state, a, ((_IDLE,), fp, neps)),
            )

    # -- properties ----------------------------------------------------

    def check(
        self, state: tuple, label: str, info: dict, nxt: tuple
    ) -> List[str]:
        """Safety violations for one transition (empty when clean).
        Deliberately INDEPENDENT re-derivations — they validate the
        transition relation above, so an edit that breaks the protocol
        tables is caught by exploration, not hidden by shared code."""
        out: List[str] = []
        b = self.bounds
        event = info.get("event", "")

        # (3) admission inflight <= cap in every reachable state
        for r, (_, _, _, proc, _) in enumerate(nxt[1]):
            if len(proc) > b.ingest_cap:
                out.append(
                    "admission-cap: replica r%d holds %d concurrent "
                    "resync ingests (cap %d) after %s"
                    % (r, len(proc), b.ingest_cap, label)
                )

        # (1) no double full-pack admission per (tenant, restart-epoch)
        if event == "admit-full-pack" and info["bit"]:
            out.append(
                "double-full-pack: tenant a%d admitted twice at "
                "replica r%d within restart epoch %d (%s)"
                % (info["agent"], info["replica"], info["epoch"], label)
            )

        # (2) no delta applied over a mismatched fingerprint
        if event == "apply-delta" and (
            info["cached"] != info["base"] or info["base"] == _NO_FP
        ):
            out.append(
                "delta-fingerprint: delta from a%d applied at r%d over "
                "cached fp %s != base fp %s (%s)"
                % (info["agent"], info["replica"], info["cached"],
                   info["base"], label)
            )

        # (4) version-mix never carries a frame the negotiated version
        # forbids (replies mirror the REQUEST version)
        kind = info.get("kind")
        if kind is not None:
            if KINDS[kind].min_version > info["version"]:
                out.append(
                    "version-gate: %s carried to/from a v%d agent "
                    "(min version %d) on %s"
                    % (kind, info["version"], KINDS[kind].min_version,
                       label)
                )
        return out

    def is_goal(self, state: tuple) -> bool:
        """The drained state: everyone idle, no breaker stuck open,
        and every tenant served through a closed-breaker endpoint —
        current-wire tenants cached + acked there. A HALF-OPEN breaker
        on an unused backup endpoint is part of the drained steady
        state (the ladder rightly never probes past a healthy
        primary); an OPEN one is not, but can always expire, so goal
        reachability proves no breaker livelocks against a healthy
        replica."""
        agents, replicas, _ = state
        for a, (phase, fp, eps) in enumerate(agents):
            if phase[0] != _IDLE:
                return False
            if any(brk == _OPEN for _, _, brk in eps):
                return False
            if self.bounds.versions[a] >= 4:
                if not any(
                    eps[r][0] == fp and replicas[r][1][a] == fp
                    and eps[r][2] == _CLOSED
                    for r in range(self.bounds.n_replicas)
                ):
                    return False
            else:
                if not any(brk == _CLOSED for _, _, brk in eps):
                    return False
        return True


def build_systems() -> List[ProtocolSystem]:
    """The product automata the proto tier explores."""
    return [ProtocolSystem(bounds) for bounds in CHECK_BOUNDS]
