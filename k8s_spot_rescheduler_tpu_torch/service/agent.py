"""The per-cluster agent: a Planner whose solver lives across the wire.

The port of the JAX package's ``service/agent.py``. ``RemotePlanner``
implements the ``Planner`` surface the control loop speaks (plan /
plan_async / plan_schedule), so the agent topology changes nothing
above the planner boundary: observe, pack and actuate stay local. What
moves is the solve: the locally-packed ``PackedCluster`` ships to a
planner service (``service/server.py``, of either package) over the
binary wire protocol (``service/wire.py``), and the selection vector
comes back.

Degradation is the agent's job, and it is a ladder:

1. **failover** — the agent takes an ordered list of planner endpoints
   (``planner_urls`` / a comma list in ``planner_url``). Each endpoint
   has its own consecutive-failure breaker; a tick walks the list in
   order, skipping breaker-open endpoints and failing over past an
   endpoint that resets, times out, 5xxs, or answers out of protocol.
   Served-after-failover ticks are counted
   (``remote_planner_failover_total``) and evented (flight kind
   ``failover``) from the same site.
2. **local fallback** — only when EVERY endpoint is dead or breaker-open
   does the tick plan in process on the numpy oracle
   (``remote_planner_fallback_total``, flight
   ``remote-planner-fallback``); the agent runs no kernels of its own.

A 503's ``Retry-After`` is honored below the breaker threshold as the
skip window; at/above the threshold the skip window is
``max(doubling backoff, Retry-After)`` with the server-suggested value
capped at ``RETRY_AFTER_CAP_S``, stretched by a private urandom-seeded
jitter; a KIND_RESYNC full-pack retry sleeps a jittered delay first, so
a fleet-wide restart does not bring every agent back at once.

The transport is a seam (``self.transport``, by default the persistent
keep-alive ``PooledWireTransport``): with a service chaos profile,
``service/chaos.ChaosAgentTransport`` wraps it, handed the pool.
"""

from __future__ import annotations

import contextlib
import dataclasses
import http.client
import random
import socket
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.loop import flight
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.models.cluster import PDBSpec
from k8s_spot_rescheduler_tpu_torch.planner.base import PlanReport, pack_observation
from k8s_spot_rescheduler_tpu_torch.service import wire
from k8s_spot_rescheduler_tpu_torch.utils.clock import Clock, RealClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing


class RemoteCallError(Exception):
    """A planner-service call failed at the HTTP layer (typed so the
    503 Retry-After can ride along to the breaker)."""

    def __init__(self, message: str, retry_after: float):
        super().__init__(message)
        self.retry_after = float(retry_after)


class _Endpoint:
    """Per-endpoint breaker state: failures at replica A must not make
    the agent skip replica B. ``acked_fp`` is the fingerprint of the
    last pack THIS endpoint acknowledged (full upload or applied
    delta) — the delta wire ships churn only to an endpoint whose
    acknowledged state IS the delta's base, so a failover target (or a
    repointed url) gets a full pack by construction, without waiting
    for the server's resync demand. The protocol model's
    ``ENDPOINT_FIELDS`` is bound to these ``__slots__``
    (service/protocol_model.py)."""

    __slots__ = ("url", "consecutive_failures", "skip_until", "acked_fp")

    def __init__(self, url: str):
        self.url = url.rstrip("/")
        self.consecutive_failures = 0
        self.skip_until = 0.0  # on the agent's clock (monotonic)
        self.acked_fp = ""  # last pack fingerprint this replica holds


# public name: the fleet twin (service/twin.py) reuses the per-endpoint
# breaker state object rather than growing a parallel one
Endpoint = _Endpoint


# longest HTTP status/header line the pooled reader accepts (matches
# http.client's own _MAXLINE discipline)
_MAX_LINE = 65536


class _WireSocket:
    """One persistent keep-alive connection to a planner endpoint, with
    HTTP/1.1 request pipelining.

    Writes are serialized under a send lock and each request takes a
    FIFO *ticket*; replies are read strictly in ticket order (the
    HTTP/1.1 pipelining contract), so a second request — the overlapped
    metrics-pass upload, a concurrent direct caller — can go on the
    wire while the first reply is still in flight instead of opening a
    second socket. One buffered reader lives for the connection's whole
    life: response parsing can never strand the next reply's bytes in
    a discarded per-response buffer.

    Any send/parse failure marks the connection ``broken``; the pool
    discards it and the transport's stale-retry contract decides
    whether the failure counts (see :class:`PooledWireTransport`)."""

    def __init__(self, host: str, port: int, timeout: float,
                 tls: bool = False):
        t0 = time.perf_counter()
        self.sock = socket.create_connection((host, port), timeout=timeout)
        if tls:
            import ssl

            self.sock = ssl.create_default_context().wrap_socket(
                self.sock, server_hostname=host
            )
        self.connect_ms = (time.perf_counter() - t0) * 1e3
        with contextlib.suppress(OSError):
            self.sock.setsockopt(
                socket.IPPROTO_TCP, socket.TCP_NODELAY, 1
            )
        self.rfile = self.sock.makefile("rb")
        self.requests = 0  # requests ever sent on this connection
        self.broken = False
        self._send_lock = threading.Lock()
        self._read_cond = threading.Condition()
        self._next_ticket = 0
        self._next_read = 0

    @property
    def idle(self) -> bool:
        """No reply in flight (every sent request has been read)."""
        return self._next_ticket == self._next_read

    def send(self, data: bytes, timeout: float) -> Tuple[int, bool]:
        """Write one request; returns ``(ticket, reused)`` where
        ``reused`` is True when this connection had already served
        traffic (the reuse-vs-fresh distinction the stale-retry
        contract and the reuse counter both key on)."""
        with self._send_lock:
            if self.broken:
                raise ConnectionError(
                    "pooled connection already marked broken"
                )
            reused = self.requests > 0
            self.requests += 1
            self.sock.settimeout(max(0.05, timeout))
            try:
                # the send lock is HELD across the socket write on
                # purpose: it serializes whole frames onto the shared
                # pipelined connection — two ticks interleaving bytes
                # mid-frame would corrupt the wire
                self.sock.sendall(data)  # noqa: lock-graph
            except BaseException:
                self.broken = True
                raise
            ticket = self._next_ticket
            self._next_ticket += 1
            return ticket, reused

    def read(self, ticket: int, deadline: float):
        """Read the reply for ``ticket`` (FIFO pipeline order); returns
        ``(status, headers, body, keep_alive)``."""
        with self._read_cond:
            while self._next_read != ticket:
                if self.broken:
                    raise ConnectionError(
                        "pooled connection broke ahead in the pipeline"
                    )
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    self.broken = True
                    self._read_cond.notify_all()
                    raise TimeoutError(
                        "pipelined reply timed out behind earlier "
                        "requests"
                    )
                self._read_cond.wait(min(remaining, 0.05))
            if self.broken:
                raise ConnectionError(
                    "pooled connection broke ahead in the pipeline"
                )
            try:
                return self._read_response(deadline)
            except BaseException:
                self.broken = True
                raise
            finally:
                self._next_read += 1
                self._read_cond.notify_all()

    def _read_response(self, deadline: float):
        self.sock.settimeout(max(0.05, deadline - time.perf_counter()))
        status_line = self.rfile.readline(_MAX_LINE + 1)
        if not status_line:
            # EOF before any reply byte: the server closed this
            # keep-alive connection while it sat idle — THE stale
            # half-closed case the retry-once contract exists for
            raise ConnectionError(
                "server closed the keep-alive connection"
            )
        try:
            version, code_raw = status_line.split(None, 2)[:2]
            code = int(code_raw)
        except (ValueError, IndexError) as err:
            raise ConnectionError(
                f"malformed HTTP status line {status_line[:64]!r}"
            ) from err
        headers = http.client.parse_headers(self.rfile)
        try:
            length = int(headers.get("Content-Length", 0) or 0)
        except (TypeError, ValueError):
            length = 0
        body = self.rfile.read(length) if length > 0 else b""
        if length > 0 and len(body) < length:
            raise ConnectionError(
                "keep-alive reply truncated mid-body"
            )
        conn_hdr = (headers.get("Connection") or "").lower()
        keep = version.startswith(b"HTTP/1.1") and "close" not in conn_hdr
        return code, headers, body, keep

    def close(self) -> None:
        with self._read_cond:
            self.broken = True
            self._read_cond.notify_all()
        with contextlib.suppress(Exception):
            self.rfile.close()
        with contextlib.suppress(Exception):
            self.sock.close()


class PooledWireTransport:
    """The default agent transport: a persistent keep-alive connection
    pool behind the ``RemotePlanner.transport`` seam (same callable
    shape ``(url, body, headers, timeout) -> bytes``).

    - **One connection per endpoint**, reused across ticks AND across
      the failover ladder: a breaker-expiry failback to the primary
      rides the primary's still-pooled socket, and
      ``MAX_CONNS_PER_ENDPOINT`` bounds the pool by construction —
      concurrent requests share the endpoint's connection via HTTP/1.1
      pipelining (:class:`_WireSocket`) instead of fanning out sockets.
    - **Stale-retry contract** (docs/ROBUSTNESS.md): a send/parse
      failure on a connection that had already served traffic —
      server restart, idle-timeout close, LB reset between ticks — is
      retried exactly ONCE on a fresh connection
      (``remote_wire_reconnects_total``) before it propagates as an
      endpoint failure. Failures on a *fresh* connection, and genuine
      deadline timeouts, propagate immediately (retrying a timeout
      would double the stall).
    - **Accounting**: reuses feed ``remote_wire_connection_reuse_total``;
      a fresh connect's handshake time is handed to the caller's
      thread via :meth:`take_last_call` and grafted as the
      ``wire.connect`` span under ``wire.request`` — socket economics
      are visible per tick, not just in aggregate.

    Thread-safe; trace mutation stays on the caller (RemotePlanner
    reads ``take_last_call`` on the worker thread into the box and
    grafts on the finish thread, the same single-threaded-trace
    discipline as the rest of the wire accounting)."""

    # hard per-endpoint connection bound: requests PIPELINE rather than
    # fan out, so one socket per endpoint is the steady state and the
    # ceiling (the JAX package's tests/test_wire_pool.py hammers it)
    MAX_CONNS_PER_ENDPOINT = 1

    def __init__(self):
        self._lock = threading.Lock()
        self._conns: Dict[Tuple[str, int, bool], _WireSocket] = {}
        self._tls = threading.local()

    # ------------------------------------------------------------------

    @staticmethod
    def _endpoint(url: str) -> Tuple[Tuple[str, int, bool], str, str]:
        parsed = urllib.parse.urlsplit(url)
        tls = parsed.scheme == "https"
        host = parsed.hostname or "localhost"
        port = parsed.port or (443 if tls else 80)
        path = parsed.path or "/"
        if parsed.query:
            path = f"{path}?{parsed.query}"
        return (host, port, tls), host, path

    @staticmethod
    def _request_bytes(
        host: str, port: int, path: str, body: bytes, headers: dict
    ) -> bytes:
        lines = [
            f"POST {path} HTTP/1.1",
            f"Host: {host}:{port}",
            f"Content-Length: {len(body)}",
            "Connection: keep-alive",
        ]
        lines.extend(f"{k}: {v}" for k, v in headers.items())
        return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1") + body

    def _checkout(self, key, timeout: float) -> _WireSocket:
        """The endpoint's pooled connection, or a fresh one when none
        is live. The pool holds at most MAX_CONNS_PER_ENDPOINT (=1)
        connection per endpoint — ever."""
        with self._lock:
            conn = self._conns.get(key)
            if conn is not None and not conn.broken:
                return conn
            if conn is not None:
                conn.close()
            conn = _WireSocket(key[0], key[1], timeout, tls=key[2])
            self._conns[key] = conn
            return conn

    def _discard(self, key, conn: _WireSocket) -> None:
        with self._lock:
            if self._conns.get(key) is conn:
                del self._conns[key]
        conn.close()

    # ------------------------------------------------------------------

    def __call__(
        self, url: str, body: bytes, headers: dict, timeout: float
    ) -> bytes:
        key, host, path = self._endpoint(url)
        data = self._request_bytes(host, key[1], path, body, headers)
        deadline = time.perf_counter() + timeout
        info = {"connect_ms": 0.0, "reused": False, "reconnected": False}
        self._tls.last_call = info
        for attempt in (0, 1):
            budget = max(0.05, deadline - time.perf_counter())
            conn = self._checkout(key, budget)
            try:
                ticket, reused = conn.send(data, budget)
                code, hdrs, payload, keep = conn.read(ticket, deadline)
            except TimeoutError:
                # a genuine deadline timeout is not staleness: retrying
                # would stall the tick twice. The ladder owns it.
                self._discard(key, conn)
                raise
            except (ConnectionError, OSError):
                self._discard(key, conn)
                if conn.requests > 1 and attempt == 0:
                    # the stale-socket contract: a connection that had
                    # already served traffic may have been half-closed
                    # between ticks — ONE transparent retry on a fresh
                    # socket before this counts as an endpoint failure
                    metrics.update_remote_wire_reconnect()
                    info["reconnected"] = True
                    continue
                raise
            if not reused:
                info["connect_ms"] = conn.connect_ms
            info["reused"] = reused
            if reused:
                metrics.update_remote_wire_reuse()
            if not keep:
                # the server said close (drain-refuse, pre-body reject,
                # HTTP/1.0 peer): honor it — never pool a socket whose
                # next reply would desync
                self._discard(key, conn)
            if code != 200:
                retry_after = 0.0
                if code == 503:
                    try:
                        retry_after = float(hdrs.get("Retry-After", 0))
                    except (TypeError, ValueError):
                        retry_after = 0.0
                detail = ""
                try:
                    wire.decode_plan_reply(payload)
                except wire.WireError as werr:
                    detail = str(werr)
                raise RemoteCallError(
                    f"HTTP {code}{': ' + detail if detail else ''}",
                    retry_after,
                )
            return payload
        raise ConnectionError("unreachable")  # pragma: no cover

    # ------------------------------------------------------------------
    # caller-facing accounting + lifecycle

    def take_last_call(self) -> Optional[dict]:
        """Pop this thread's last call's connection accounting
        (``connect_ms``/``reused``/``reconnected``), or None when no
        pooled call happened on this thread since the last take."""
        info = getattr(self._tls, "last_call", None)
        self._tls.last_call = None
        return info

    def connection_count(self) -> int:
        """Live pooled connections, across endpoints (at most one an
        endpoint)."""
        with self._lock:
            return len(self._conns)

    def break_idle(self) -> int:
        """OS-level half-close of every pooled connection with no reply
        in flight, LEAVING it in the pool — exactly what a server-side
        idle-timeout close between ticks looks like to the agent. The
        chaos half-closed-socket fault (service/chaos.py) calls this;
        the next request must discover the stale socket and retry once
        on a fresh one. Returns the number of connections broken."""
        with self._lock:
            conns = list(self._conns.values())
        broken = 0
        for conn in conns:
            if conn.idle and not conn.broken:
                with contextlib.suppress(OSError):
                    conn.sock.shutdown(socket.SHUT_RDWR)
                broken += 1
        return broken

    def close(self) -> None:
        with self._lock:
            conns = list(self._conns.values())
            self._conns.clear()
        for conn in conns:
            conn.close()


class RemotePlanner:
    """Planner over a remote multi-tenant planner service (or an
    ordered failover list of its replicas)."""

    accepts_columnar = True

    # breaker: consecutive failures before an endpoint is skipped, and
    # the doubling skip window (seconds) that failure cadence buys
    FAIL_THRESHOLD = 2
    BACKOFF_BASE = 5.0
    BACKOFF_MAX = 120.0
    # cap on the SERVER-suggested Retry-After contribution to the skip
    # window (a misconfigured LB header must not stall failback for
    # hours; outages past this belong to the doubling backoff)
    RETRY_AFTER_CAP_S = 30.0
    # decorrelation jitter: the suggested horizon is stretched by a
    # per-agent random factor in [1.0, 1 + this) before it opens the
    # skip window — N agents refused with the SAME Retry-After must
    # not come back in the same instant (the herd the horizon exists
    # to spread)
    RETRY_JITTER_FRAC = 0.5
    # spread (seconds) of the jittered delay before a KIND_RESYNC
    # full-pack retry — a fleet-wide restart demands resyncs from
    # every agent in the same tick; an immediate retry would be a
    # perfectly synchronized full-pack herd by construction. Bounded
    # by the remaining tick deadline budget.
    RESYNC_JITTER_S = 2.0

    def __init__(
        self,
        config: ReschedulerConfig,
        url: str = "",
        *,
        tenant: Optional[str] = None,
        timeout: Optional[float] = None,
        clock: Optional[Clock] = None,
    ):
        self.config = config
        raw = url or config.planner_urls or config.planner_url
        self._endpoints: List[Endpoint] = [
            Endpoint(u.strip()) for u in raw.split(",") if u.strip()
        ]
        if not self._endpoints:
            raise ValueError("RemotePlanner needs a planner service url")
        import socket

        self.tenant = tenant or socket.gethostname()
        self.timeout = float(
            timeout if timeout is not None else config.planner_timeout
        )
        self.clock = clock or RealClock()
        # seam: (url, body, headers, timeout) -> reply bytes; raises
        # RemoteCallError for HTTP errors. Default = the persistent
        # keep-alive pool; _transport_urllib stays as the fresh-
        # connection-per-request baseline (bench/service_smoke.
        # serve_smoke measures the pool against it in the same run);
        # service/chaos.py wraps either, handed the pool.
        self._wire_pool = PooledWireTransport()
        self.transport = self._wire_pool
        if config.service_chaos_profile not in ("", "off", "none"):
            from k8s_spot_rescheduler_tpu_torch.service.chaos import (
                ChaosAgentTransport,
                ServiceFaultPlan,
            )

            log.info(
                "CHAOS: service-path fault injection on the agent "
                "transport (profile=%s seed=%d) — testing mode",
                config.service_chaos_profile, config.service_chaos_seed,
            )
            self.transport = ChaosAgentTransport(
                self.transport,
                ServiceFaultPlan.profile(
                    config.service_chaos_profile,
                    config.service_chaos_seed,
                ),
                clock=self.clock,
                pool=self._wire_pool,
            )
        self._pad_c = 0
        self._pad_s = 0
        self._pad_k = config.max_pods_per_node_hint
        # private urandom-seeded instance (the kube read path's PR-4
        # lesson): retry jitter must decorrelate agents/restarts — a
        # fixed seed would synchronize the very herd it exists to
        # spread — without perturbing global random state
        self._retry_rng = random.Random()
        self._fallback = None  # lazy local numpy-oracle planner
        # delta wire (v4): the previous tick's pack + its fingerprint —
        # what this tick's churn delta is diffed against (the agent's
        # half of the anti-entropy pair; the service holds the other)
        self._prev_packed = None
        self._prev_fp = ""
        self.last_solver = "remote"
        self.last_endpoint = ""
        # the trace the last plan recorded into: the controller's tick
        # trace when one is ambient, else a standalone trace (direct
        # callers read the grafted span tree off this); None with
        # tracing disabled
        self.last_trace = None

    @property
    def urls(self) -> List[str]:
        return [ep.url for ep in self._endpoints]

    # ------------------------------------------------------------------

    def _fallback_planner(self):
        """The local fallback: the planner on the host numpy oracle."""
        if self._fallback is None:
            from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
                TorchSolverPlanner,
            )

            self._fallback = TorchSolverPlanner(
                dataclasses.replace(
                    self.config, solver="numpy",
                    planner_url="", planner_urls="",
                )
            )
        return self._fallback

    def _jittered_horizon(self, suggested: float) -> float:
        """Stretch a (already-capped) server-suggested horizon by this
        agent's private jitter: uniform in [1.0, 1+RETRY_JITTER_FRAC).
        A storm refuses hundreds of agents with near-identical
        Retry-After values; without this they would all come back in
        the same instant and re-form the herd the 503 just shed."""
        return suggested * (
            1.0 + self._retry_rng.random() * self.RETRY_JITTER_FRAC
        )

    def _note_failure(
        self, ep: Endpoint, why: str, retry_after: float = 0.0
    ) -> None:
        ep.consecutive_failures += 1
        # one bad LB header must not stall failback for hours: the
        # server-suggested horizon is capped wherever it feeds the skip
        # window (regression-tested; docs/ROBUSTNESS.md), then jittered
        # per agent so equal horizons don't re-synchronize the fleet
        suggested = min(max(retry_after, 0.0), self.RETRY_AFTER_CAP_S)
        if suggested > 0:
            suggested = self._jittered_horizon(suggested)
        if ep.consecutive_failures >= self.FAIL_THRESHOLD:
            n = ep.consecutive_failures - self.FAIL_THRESHOLD
            backoff = min(
                self.BACKOFF_BASE * (2.0 ** n), self.BACKOFF_MAX
            )
            # a LONGER server-suggested Retry-After beats the schedule
            # (the server knows its queue) — capped above
            backoff = max(backoff, suggested)
            ep.skip_until = self.clock.now() + backoff
            log.error(
                "planner endpoint %s unusable (%s; %d consecutive "
                "failures); skipping it for %.1fs",
                ep.url, why, ep.consecutive_failures, backoff,
            )
        elif suggested > 0:
            # a single 503 already names its horizon: honor it without
            # waiting for the threshold
            ep.skip_until = self.clock.now() + suggested
            log.warning(
                "planner endpoint %s overloaded (%s); retrying after %.1fs",
                ep.url, why, suggested,
            )
        else:
            log.warning(
                "planner endpoint %s call failed: %s", ep.url, why
            )

    def _note_success(self, ep: Endpoint) -> None:
        if ep.consecutive_failures:
            log.info(
                "planner endpoint %s healthy again after %d failed call(s)",
                ep.url, ep.consecutive_failures,
            )
        ep.consecutive_failures = 0
        ep.skip_until = 0.0

    def _transport_urllib(
        self, url: str, body: bytes, headers: dict, timeout: float
    ) -> bytes:
        """The fresh-connection-per-request baseline: one urllib POST,
        reply bytes back. HTTP error statuses become
        :class:`RemoteCallError` carrying any 503 Retry-After;
        everything else propagates as-is."""
        req = urllib.request.Request(
            url, data=body, headers=headers, method="POST"
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as err:
            retry_after = 0.0
            if err.code == 503:
                try:
                    retry_after = float(err.headers.get("Retry-After", 0))
                except (TypeError, ValueError):
                    retry_after = 0.0
            detail = ""
            try:
                wire.decode_plan_reply(err.read())
            except wire.WireError as werr:
                detail = str(werr)
            raise RemoteCallError(
                f"HTTP {err.code}{': ' + detail if detail else ''}",
                retry_after,
            ) from err

    def _pack_observation(self, observation, pdbs):
        """The shared pack path (planner/base.pack_observation) with
        the agent's high-water pads — stable shapes keep the whole
        fleet in few service-side buckets; shared by plan_async,
        plan_schedule, and the drain-schedule execution handle."""
        return pack_observation(self, observation, pdbs)

    def _resync_retry_delay(self, remaining: float) -> float:
        """Jittered decorrelation delay before the KIND_RESYNC
        full-pack retry: uniform over [0, RESYNC_JITTER_S], clamped to
        at most half the remaining deadline budget (the retry must
        still have room to complete). 0 when the budget is exhausted."""
        spread = min(self.RESYNC_JITTER_S, max(0.0, remaining * 0.5))
        if spread <= 0:
            return 0.0
        return self._retry_rng.uniform(0.0, spread)

    def _ladder_call(self, path: str, body: bytes, headers: dict,
                     decode, box: dict, delta_body: bytes = None,
                     base_fp: str = "", new_fp: str = "") -> None:
        """Walk the ordered endpoint list under ONE deadline budget:
        the tick's documented planner_timeout bounds the whole call,
        not each endpoint — three blackholed replicas must not stall
        the loop 3x the deadline. Fills ``box`` with the decoded reply
        + serving endpoint (or just the attempts on total failure).

        Delta wire: with ``delta_body`` given, an endpoint whose
        acknowledged fingerprint equals ``base_fp`` is sent the churn
        delta instead of the full pack; a KIND_RESYNC answer retries
        the full pack on the SAME endpoint within the same budget (a
        resync is protocol, not a failure — no breaker, no failover).
        A serving endpoint's ``acked_fp`` advances to ``new_fp``, so
        failover targets get a full pack by construction."""
        box["t_send"] = time.perf_counter()
        deadline = box["t_send"] + self.timeout
        skipped = 0
        for ep in self._endpoints:
            if self.clock.now() < ep.skip_until:
                # counts toward failover only if it precedes the
                # endpoint that eventually serves
                skipped += 1
                continue
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                box["attempts"].append((
                    ep.url,
                    "plan deadline exhausted before this "
                    "endpoint was tried",
                    0.0,
                ))
                # not an endpoint failure: its breaker is
                # untouched — we simply ran out of budget
                continue
            use_delta = delta_body is not None and ep.acked_fp == base_fp
            t_ep = time.perf_counter()

            def _call(payload: bytes, budget: float) -> bytes:
                # one transport invocation + the pool's per-call socket
                # accounting (connect time, reuse, stale reconnects)
                # copied into the box on THIS worker thread; the finish
                # thread grafts it (traces are single-threaded)
                raw = self.transport(
                    f"{ep.url}{path}", payload, headers, budget
                )
                pool = self._wire_pool
                if pool is not None:
                    conn_info = pool.take_last_call()
                    if conn_info is not None:
                        box["wire_conn"] = conn_info
                return raw

            try:
                raw = _call(
                    delta_body if use_delta else body,
                    max(0.05, remaining),
                )
                reply = (
                    wire.decode_plan_or_resync(raw)
                    if use_delta
                    else decode(raw)
                )
                if isinstance(reply, wire.ResyncDemand):
                    # the service cannot honor the delta's base
                    # (restart, eviction, mismatch, corruption): one
                    # full pack to the SAME endpoint, same budget.
                    # NOT immediately — a replica restart stales every
                    # agent's fingerprint in the same tick, and a
                    # zero-jitter retry is a perfectly synchronized
                    # full-pack herd by construction. Sleep a private
                    # urandom-jittered delay (bounded so most of the
                    # budget is left for the retry itself) before the
                    # one full pack.
                    box["resyncs"] = box.get("resyncs", 0) + 1
                    log.info(
                        "planner endpoint %s demanded a full-pack "
                        "resync: %s", ep.url, reply.cause,
                    )
                    remaining = deadline - time.perf_counter()
                    delay = self._resync_retry_delay(remaining)
                    if delay > 0:
                        self.clock.sleep(delay)
                        remaining = deadline - time.perf_counter()
                    raw = _call(body, max(0.05, remaining))
                    reply = decode(raw)
            except RemoteCallError as err:
                self._note_failure(ep, str(err), err.retry_after)
                box["attempts"].append((
                    ep.url, str(err),
                    (time.perf_counter() - t_ep) * 1e3,
                ))
                continue
            except Exception as err:  # noqa: BLE001, exception-discipline — transport/protocol failure of ONE endpoint: recorded as a failover attempt and the ladder continues; the terminal all-dead case is counted+evented by the caller
                self._note_failure(ep, str(err), 0.0)
                box["attempts"].append((
                    ep.url, str(err),
                    (time.perf_counter() - t_ep) * 1e3,
                ))
                continue
            self._note_success(ep)
            if new_fp:
                # this replica now holds exactly the new pack (full
                # upload, or delta applied over an acknowledged base)
                ep.acked_fp = new_fp
            box["reply"] = reply
            box["endpoint"] = ep.url
            box["skipped_before"] = skipped
            break
        box["t_recv"] = time.perf_counter()

    def _note_wire_outcome(self, trace, box, spans, attrs=None) -> None:
        """The shared post-ladder accounting: graft each FAILED
        endpoint attempt, fire the failover metric + flight event when
        the serving endpoint was not first choice (same site, so the
        two surfaces always agree), and graft the server's span block
        under the measured round trip."""
        attempts = box["attempts"]
        if trace is not None:
            for ep_url, why, dur_ms in attempts:
                trace.graft(
                    tracing.make_span("wire.failover", 0.0, dur_ms),
                    attrs={"endpoint": ep_url, "error": True},
                )
        if box.get("reply") is None:
            return
        skipped_before = box.get("skipped_before", 0)
        if attempts or skipped_before:
            # served, but only after at least one EARLIER endpoint
            # failed or was breaker-open: a failover tick. (A
            # breaker-open endpoint LATER in the list is irrelevant —
            # the primary serving is healthy.)
            metrics.update_remote_planner_failover()
            flight.note_event(
                "failover",
                cause=(
                    f"{len(attempts)} endpoint(s) failed, "
                    f"{skipped_before} breaker-open; served by "
                    f"{box.get('endpoint', '?')}"
                ),
                trace_id=(
                    trace.trace_id if trace is not None else ""
                ),
                endpoints_tried=len(attempts) + skipped_before + 1,
            )
        if trace is not None:
            if box.get("resyncs"):
                # surface a served-after-resync tick on the trace tree
                attrs = dict(attrs or {})
                attrs["delta_resyncs"] = box["resyncs"]
            # graft the server's span block under the measured round
            # trip; the residual (rtt minus server-side work) is the
            # wire itself — tunnel, TLS, serialization on the path
            rtt_ms = max(0.0, (box["t_recv"] - box["t_send"]) * 1e3)
            server_ms = sum(d for _, _, d in spans)
            children = list(spans)
            conn_info = box.get("wire_conn")
            if conn_info is not None:
                attrs = dict(attrs or {})
                attrs["wire_reused"] = bool(conn_info.get("reused"))
                if conn_info.get("reconnected"):
                    attrs["wire_reconnected"] = True
                if conn_info.get("connect_ms"):
                    # a fresh TCP connect happened inside this round
                    # trip (first tick, failback, stale replacement);
                    # on a reused socket the span is absent — its
                    # absence IS the sub-RTT win
                    children.append(
                        tracing.make_span(
                            "wire.connect", 0.0,
                            float(conn_info["connect_ms"]),
                        )
                    )
            trace.graft(
                tracing.make_span("wire.request", 0.0, rtt_ms),
                children=children,
                attrs=attrs,
            )
            trace.graft(
                tracing.make_span(
                    "wire.transfer", 0.0, max(0.0, rtt_ms - server_ms)
                )
            )

    # ------------------------------------------------------------------
    # Planner surface

    def plan(self, observation, pdbs: Sequence[PDBSpec]) -> PlanReport:
        return self.plan_async(observation, pdbs)()

    def plan_async(self, observation, pdbs: Sequence[PDBSpec]):
        """Pack locally, walk the endpoint ladder on a worker thread
        (the loop's metrics pass overlaps the network round trips
        exactly as it overlaps the in-process device solve), and return
        the blocking ``finish`` callable.

        Tracing: the pack and the wire round trip record into the
        controller's ambient tick trace (or a standalone trace for
        direct callers); the tick's trace ID ships with the request
        (wire v2 frame + ``X-Trace-Id``) and the serving endpoint's
        spans come back in the reply and are grafted under
        ``wire.request``; each FAILED endpoint attempt grafts a
        ``wire.failover`` span. The worker thread only stores raw
        timestamps and outcomes; all trace mutation happens on the
        caller's thread at ``finish`` (traces are single-threaded)."""
        t0 = time.perf_counter()
        cfg = self.config
        trace = tracing.current_trace()
        if trace is None and cfg.trace_enabled:
            trace = tracing.Trace()
        self.last_trace = trace

        def _sp(name, **attrs):
            return (
                trace.span(name, **attrs)
                if trace is not None
                else contextlib.nullcontext()
            )

        with _sp("plan.pack"):
            packed, meta = self._pack_observation(observation, pdbs)

        for blocked in meta.blocking_pods():
            log.info("BlockingPod: %s (%s)", blocked.pod.uid, blocked.reason)

        live = [
            ep for ep in self._endpoints
            if self.clock.now() >= ep.skip_until
        ]
        box: dict = {"attempts": [], "skipped_before": 0}
        worker: Optional[threading.Thread] = None
        # delta wire (v4): fingerprint this pack, diff it against the
        # previous tick's, and remember it as the next tick's base —
        # regardless of how THIS tick ends (fallback included), since
        # the per-endpoint acked fingerprints are what gate shipping
        fp = ""
        delta = None
        base_fp = ""
        if cfg.delta_wire_enabled:
            from k8s_spot_rescheduler_tpu_torch.models.delta import (
                emit_packed_delta,
                pack_fingerprint,
            )

            with _sp("plan.fingerprint"):
                fp = pack_fingerprint(packed)
            if self._prev_packed is not None:
                with _sp("plan.delta-emit"):
                    # None on shape growth past the high-water pads:
                    # this tick ships the full pack (and re-seeds)
                    delta = emit_packed_delta(self._prev_packed, packed)
                base_fp = self._prev_fp
            self._prev_packed = packed
            self._prev_fp = fp
        if live:
            trace_id = trace.trace_id if trace is not None else ""
            body = wire.encode_plan_request(
                self.tenant, packed, trace_id=trace_id,
                pack_fingerprint=fp,
            )
            delta_body = None
            if delta is not None and any(
                ep.acked_fp == base_fp for ep in live
            ):
                delta_body = wire.encode_packed_delta(
                    self.tenant, delta,
                    base_fingerprint=base_fp, new_fingerprint=fp,
                    trace_id=trace_id,
                )
            headers = {
                "Content-Type": "application/octet-stream",
                # declare our own deadline so the service evicts (and
                # frees the slot of) a request we will have abandoned
                "X-Planner-Deadline": f"{self.timeout:.3f}",
            }
            if trace_id:
                # belt to the wire frame: proxies/logs see the
                # correlation id even when the binary body is opaque
                headers["X-Trace-Id"] = trace_id

            def call():
                self._ladder_call(
                    "/v2/plan", body, headers, wire.decode_plan_reply,
                    box, delta_body=delta_body, base_fp=base_fp,
                    new_fp=fp,
                )

            worker = threading.Thread(target=call, daemon=True)
            worker.start()

        def finish() -> PlanReport:
            if worker is not None:
                worker.join()
            reply = box.get("reply")
            if reply is None:
                self._note_wire_outcome(trace, box, ())
                causes = "; ".join(why for _, why, _ in box["attempts"])
                return self._plan_fallback(
                    observation, pdbs,
                    cause=causes or "breaker open on every endpoint",
                )
            self.last_solver = "remote"
            self.last_endpoint = box.get("endpoint", "")
            self._note_wire_outcome(
                trace, box, reply.spans,
                attrs={
                    "batch_lanes": reply.batch_lanes,
                    "batch_tenants": reply.batch_tenants,
                },
            )
            plan = None
            if reply.found and reply.index < meta.n_candidates:
                plan = meta.build_plan(
                    reply.index, np.asarray(reply.row)
                )
            return PlanReport(
                plan=plan,
                n_candidates=meta.n_candidates,
                n_feasible=reply.n_feasible,
                solve_seconds=time.perf_counter() - t0,
                solver="remote",
                feasible_candidates=[plan] if plan else [],
            )

        return finish

    def plan_schedule(self, observation, pdbs: Sequence[PDBSpec]):
        """Fetch a whole drain schedule over the wire (wire v3
        ``schedule_horizon`` frame -> KIND_PLAN_SCHEDULE reply): pack
        locally, walk the SAME endpoint failover ladder synchronously
        (a schedule fetch happens once per ``schedule_horizon`` drains
        — there is no metrics pass to overlap), and return a
        ``planner/schedule.DrainSchedule`` whose per-step validation
        runs entirely locally, on the host (``device="cpu"``: the agent
        runs no kernels) — executing an in-flight schedule needs
        no wire at all, so a replica dying mid-schedule costs nothing
        until the NEXT cut, which fails over. Returns None when every
        endpoint is unusable; the controller then plans per tick
        (plan_async's own ladder + local-fallback accounting owns the
        degradation)."""
        from k8s_spot_rescheduler_tpu_torch.planner.schedule import DrainSchedule
        from k8s_spot_rescheduler_tpu_torch.solver.schedule import decode_schedule

        cfg = self.config
        horizon = max(1, cfg.schedule_horizon)
        trace = tracing.current_trace()
        if trace is None and cfg.trace_enabled:
            trace = tracing.Trace()
        self.last_trace = trace
        span_cm = (
            trace.span("plan.schedule")
            if trace is not None
            else contextlib.nullcontext()
        )
        with span_cm as sp:
            with (
                trace.span("plan.pack")
                if trace is not None
                else contextlib.nullcontext()
            ):
                packed, meta = self._pack_observation(observation, pdbs)
            live = [
                ep for ep in self._endpoints
                if self.clock.now() >= ep.skip_until
            ]
            if not live:
                return None
            trace_id = trace.trace_id if trace is not None else ""
            body = wire.encode_plan_request(
                self.tenant, packed, trace_id=trace_id,
                schedule_horizon=horizon,
            )
            headers = {
                "Content-Type": "application/octet-stream",
                "X-Planner-Deadline": f"{self.timeout:.3f}",
            }
            if trace_id:
                headers["X-Trace-Id"] = trace_id
            box: dict = {"attempts": [], "skipped_before": 0}
            self._ladder_call(
                "/v2/plan", body, headers,
                wire.decode_plan_schedule_reply, box,
            )
            reply = box.get("reply")
            self._note_wire_outcome(
                trace, box,
                reply.spans if reply is not None else (),
                attrs=(
                    {
                        "batch_lanes": reply.batch_lanes,
                        "batch_tenants": reply.batch_tenants,
                    }
                    if reply is not None
                    else None
                ),
            )
            if reply is None:
                log.warning(
                    "drain-schedule fetch failed on every endpoint "
                    "(%s); the tick plans per-plan instead",
                    "; ".join(why for _, why, _ in box["attempts"])
                    or "breaker open on every endpoint",
                )
                return None
            steps = decode_schedule(reply.steps)
            if sp is not None:
                sp.attrs["steps"] = len(steps)
                sp.attrs["horizon"] = horizon
        metrics.update_plan_schedule_len(len(steps))
        self.last_solver = "remote"
        self.last_endpoint = box.get("endpoint", "")
        return DrainSchedule(
            steps,
            packed,
            meta,
            pack_fn=self._pack_observation,
            solver_label="remote+schedule",
            horizon=horizon,
            base_observation=observation,
            device="cpu",
        )

    def _plan_fallback(self, observation, pdbs, cause: str = "") -> PlanReport:
        """This tick plans locally (numpy oracle) — every endpoint is
        down, slow, overloaded or out of protocol. Counted (metric +
        flight event, same site); the loop keeps running at full
        fidelity minus device speed."""
        metrics.update_remote_planner_fallback()
        flight.note_event(
            "remote-planner-fallback",
            cause=cause or "planner service unusable",
            trace_id=tracing.current_trace_id() or (
                self.last_trace.trace_id if self.last_trace else ""
            ),
        )
        report = self._fallback_planner().plan(observation, pdbs)
        self.last_solver = "remote-fallback"
        self.last_endpoint = ""
        return dataclasses.replace(report, solver="remote-fallback")
