"""Seeded fault injection for the planner-service wire/HTTP path.

The port of the JAX package's ``service/chaos.py``, the service-side
twin of ``io/chaos.py``: a seeded :class:`ServiceFaultPlan` replayed
deterministically by

- :class:`ChaosAgentTransport` — wraps a ``RemotePlanner``'s transport
  callable agent-side and injects everything a network can do to an
  HTTP client: connection resets before any byte moves, slow-loris
  uploads that eat the whole deadline, replies truncated or bit-flipped
  mid-frame (the wire decoder must answer with a typed ``WireError``,
  never an unhandled exception), scripted 503 storms with Retry-After,
  random 5xx, and reply delays past the agent's declared deadline;
- :class:`ServiceChaos` — the server-side solve/decode hook a
  ``PlannerService`` consults per batch: scripted batch-solve
  exceptions, a request-corruption rate ahead of the wire decode, and a
  scripted **sick-device phase** (extra per-batch solve latency between
  two batch indices, slept on the service's injected clock) — exactly
  the slow-degrading-accelerator mode the device-health watchdog
  (service/devhealth.py) exists to catch.

Layering mirrors io/chaos.py: agent faults sit ABOVE the real transport
(every injected failure exercises the agent's real failover/breaker/
fallback ladder), server faults sit INSIDE the batch window (the
watchdog times what the chaos clock sleeps). All draws come from one
``random.Random(plan.seed)`` stream per injector, so a fixed (plan,
call sequence) is bit-reproducible, in either package.

Two rules differ on the card (``service/server.py``): a scripted solve
error (``ServiceChaosError``) is not a fault of the card's kernels
(``ops/ffd_kernels.is_device_fault`` answers False), so it fails its
batch typed and never ends the service; and the sick phase flips the
watchdog, which on a cuda service only reports — every batch stays on
the card.
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Mapping, Optional, Tuple


class ServiceChaosError(ConnectionError):
    """An injected transport/solve failure (connection-reset class)."""


@dataclasses.dataclass(frozen=True)
class ServiceFaultPlan:
    """What to break on the service path, how often — one seeded stream.

    Agent-side (transport) knobs:

    - ``connect_reset_rate`` — probability a POST dies with a connection
      reset before any reply byte arrives.
    - ``slow_loris_rate`` — probability the upload stalls: the injected
      clock sleeps out the caller's deadline, then the timeout the
      socket would raise is raised.
    - ``reply_truncate_rate`` / ``reply_corrupt_rate`` — probability the
      reply bytes come back cut mid-frame / with one bit flipped
      (decoder must yield a typed ``WireError``).
    - ``reply_delay_s`` + ``reply_delay_rate`` — the reply is delayed
      this long; past the caller's deadline that IS a timeout.
    - ``http_503_script`` — 1-based request indices answered with a 503
      + ``http_503_retry_after`` (a scripted shed storm).
    - ``http_5xx_rate`` — probability of a plain 500.
    - ``half_close_script`` — 1-based request indices BEFORE which every
      idle pooled keep-alive connection is half-closed at the OS level
      (``PooledWireTransport.break_idle``) — the server-restarts/
      idle-timeout-between-ticks case. The agent must retry ONCE on a
      fresh socket (``remote_wire_reconnects_total``) with ZERO
      fallback/failover counted; needs the transport pool handed to
      :class:`ChaosAgentTransport` (no-op otherwise).

    Server-side (PlannerService hook) knobs:

    - ``solve_error_script`` — 1-based batch indices whose device solve
      raises (contained per batch; flips the watchdog).
    - ``sick_phase`` — ``(first_batch, last_batch, extra_latency_s)``:
      batches in the inclusive 1-based index range pay the extra solve
      latency on the service clock — the scripted sick-device phase.
    - ``request_corrupt_rate`` — probability an incoming /v2/plan body
      is bit-flipped ahead of the decode (must 400, never crash).
    """

    seed: int = 0
    # agent side
    connect_reset_rate: float = 0.0
    slow_loris_rate: float = 0.0
    reply_truncate_rate: float = 0.0
    reply_corrupt_rate: float = 0.0
    reply_delay_rate: float = 0.0
    reply_delay_s: float = 0.0
    http_503_script: Tuple[int, ...] = ()
    http_503_retry_after: float = 2.0
    http_5xx_rate: float = 0.0
    half_close_script: Tuple[int, ...] = ()
    # server side
    solve_error_script: Tuple[int, ...] = ()
    sick_phase: Tuple[float, ...] = ()
    request_corrupt_rate: float = 0.0
    extra: Mapping[str, float] = dataclasses.field(default_factory=dict)

    # single source for --service-chaos-profile choices (cli/main.py)
    PROFILES = ("", "off", "none", "light", "heavy")

    @classmethod
    def profile(cls, name: str, seed: int = 0) -> "ServiceFaultPlan":
        if name in ("", "off", "none"):
            return cls(seed=seed)
        if name == "light":
            return cls(
                seed=seed,
                connect_reset_rate=0.05,
                reply_truncate_rate=0.02,
                http_5xx_rate=0.03,
            )
        if name == "heavy":
            return cls(
                seed=seed,
                connect_reset_rate=0.10,
                slow_loris_rate=0.03,
                reply_truncate_rate=0.05,
                reply_corrupt_rate=0.05,
                http_5xx_rate=0.05,
                request_corrupt_rate=0.02,
            )
        raise ValueError(
            f"unknown service chaos profile {name!r} (known: light, heavy)"
        )


class ChaosAgentTransport:
    """Transport decorator for ``RemotePlanner``: same callable shape
    ``(url, body, headers, timeout) -> reply bytes``, faults injected
    per the plan before/after the wrapped transport runs. ``enabled``
    quiesces every fault at once (scripted counters keep their state)."""

    def __init__(self, inner, plan: ServiceFaultPlan, *, clock=None,
                 pool=None):
        self.inner = inner
        self.plan = plan
        self.clock = clock
        # the agent's PooledWireTransport (or anything with a
        # ``break_idle()``): the half-closed-keep-alive-socket fault
        # needs to reach UNDER the transport callable and kill the
        # pooled sockets at the OS level — a fault raised above the
        # pool would exercise the failover ladder, not the stale-retry
        # contract this fault exists to prove
        self.pool = pool
        self.enabled = True
        self.rng = random.Random(plan.seed)
        self.stats: collections.Counter = collections.Counter()
        self._requests = 0

    def __call__(self, url: str, body: bytes, headers, timeout: float):
        # the agent's typed HTTP error lives beside RemotePlanner; import
        # here so chaos stays optional on the agent's own import path
        from k8s_spot_rescheduler_tpu_torch.service.agent import RemoteCallError

        self._requests += 1
        n = self._requests
        plan = self.plan
        if self.enabled:
            if n in plan.half_close_script and self.pool is not None:
                # the server "restarted"/idle-timed-out between ticks:
                # every idle pooled socket is half-closed under the
                # transport's feet. NOT an injected exception — the
                # request proceeds and the pool itself must discover
                # the stale socket and retry once on a fresh one.
                self.stats["half_close"] += self.pool.break_idle()
            if plan.slow_loris_rate and self.rng.random() < plan.slow_loris_rate:
                # the upload crawls: the caller's whole deadline elapses
                # (instant on a virtual clock), then the socket timeout
                self.stats["slow_loris"] += 1
                if self.clock is not None:
                    self.clock.sleep(timeout)
                raise TimeoutError(
                    "chaos: slow-loris upload stalled past the "
                    f"{timeout:.1f}s deadline"
                )
            if (
                plan.connect_reset_rate
                and self.rng.random() < plan.connect_reset_rate
            ):
                self.stats["connect_reset"] += 1
                raise ServiceChaosError(
                    "chaos: connection reset by peer mid-frame"
                )
            if n in plan.http_503_script:
                self.stats["http_503"] += 1
                raise RemoteCallError(
                    "HTTP 503: chaos scripted shed storm",
                    plan.http_503_retry_after,
                )
            if plan.http_5xx_rate and self.rng.random() < plan.http_5xx_rate:
                self.stats["http_5xx"] += 1
                raise RemoteCallError("HTTP 500: chaos injected", 0.0)
        raw = self.inner(url, body, headers, timeout)
        if not self.enabled:
            return raw
        if (
            plan.reply_delay_rate
            and plan.reply_delay_s > 0
            and self.rng.random() < plan.reply_delay_rate
        ):
            self.stats["reply_delay"] += 1
            if self.clock is not None:
                self.clock.sleep(min(plan.reply_delay_s, timeout))
            if plan.reply_delay_s >= timeout:
                # the bytes would land after the caller stopped waiting
                raise TimeoutError(
                    "chaos: reply delayed past the "
                    f"{timeout:.1f}s deadline"
                )
        if (
            plan.reply_truncate_rate
            and len(raw) > 8
            and self.rng.random() < plan.reply_truncate_rate
        ):
            self.stats["reply_truncate"] += 1
            return raw[: self.rng.randrange(1, len(raw))]
        if (
            plan.reply_corrupt_rate
            and raw
            and self.rng.random() < plan.reply_corrupt_rate
        ):
            self.stats["reply_corrupt"] += 1
            flipped = bytearray(raw)
            i = self.rng.randrange(len(flipped))
            flipped[i] ^= 1 << self.rng.randrange(8)
            return bytes(flipped)
        return raw


class ServiceChaos:
    """Server-side hooks a ``PlannerService`` consults: ``on_batch``
    inside the timed solve window (scripted exceptions + the sick-phase
    latency the watchdog must see), ``corrupt_request`` ahead of the
    wire decode."""

    def __init__(self, plan: ServiceFaultPlan, *, clock=None):
        self.plan = plan
        self.clock = clock
        self.enabled = True
        self.rng = random.Random(plan.seed ^ 0x5EC0_51C5)
        self.stats: collections.Counter = collections.Counter()
        self._batches = 0

    def on_batch(self) -> None:
        """Called inside the device-solve timing window, once per batch
        (probes and canaries included — chaos does not know the
        difference, which is the point)."""
        self._batches += 1
        if not self.enabled:
            return
        n = self._batches
        phase = self.plan.sick_phase
        if len(phase) == 3 and phase[0] <= n <= phase[1]:
            self.stats["sick_latency"] += 1
            if self.clock is not None:
                self.clock.sleep(float(phase[2]))
        if n in self.plan.solve_error_script:
            self.stats["solve_error"] += 1
            raise ServiceChaosError(
                f"chaos: scripted batch-solve failure (batch {n})"
            )

    def sick_phase_active(self) -> bool:
        phase = self.plan.sick_phase
        return (
            self.enabled
            and len(phase) == 3
            and phase[0] <= self._batches + 1 <= phase[1]
        )

    def corrupt_request(self, body: bytes) -> Optional[bytes]:
        """A bit-flipped copy of ``body`` (the decode hook), or None to
        leave the request alone."""
        if (
            not self.enabled
            or not body
            or not self.plan.request_corrupt_rate
            or self.rng.random() >= self.plan.request_corrupt_rate
        ):
            return None
        self.stats["request_corrupt"] += 1
        flipped = bytearray(body)
        i = self.rng.randrange(len(flipped))
        flipped[i] ^= 1 << self.rng.randrange(8)
        return bytes(flipped)
