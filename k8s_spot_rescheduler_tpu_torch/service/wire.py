"""The planner service wire protocol: versioned, framed, binary.

The multi-tenant planner service (service/server.py) receives whole
``PackedCluster`` problems from per-cluster agents and returns the tiny
selection vector — tensors in both directions, never Kubernetes JSON
(the agent already packed; re-encoding 30 MB of objects would put the
decode cost the columnar path removed back on every tick). This module
is that boundary's byte format, shared by agent and server: a copy of
the JAX package's ``service/wire.py`` that writes and reads the same
bytes (``tests/test_torch_wire.py`` compares them, message kind by
message kind), so agents and services of either package talk to each
other.

Layout (all integers little-endian)::

    header   = MAGIC "KSRW" | u8 version | u8 kind | u16 frame_count
    frame    = u16 name_len | name utf-8 | u8 dtype_code | u8 ndim
             | u32 dim * ndim | u64 payload_len | payload (C-order)

Frames are dtype/shape-tagged numpy buffers; strings (tenant ids, error
text) travel as uint8 frames of utf-8 bytes. There is deliberately NO
pickle, NO schema negotiation and NO self-describing container format:
the decoder admits exactly the dtype table below and the message kinds
below, and anything else is a typed :class:`WireError` — a planner
service is a write-capable network surface and must not grow an
arbitrary-deserialization hole.

Version bump policy
-------------------
``WIRE_VERSION`` is a single byte covering the whole message layout.
Bump it when (and only when) an already-shipped frame changes meaning:
field renamed, dtype changed, header reshaped, kind renumbered. ADDING
a new frame name or a new message kind is backward compatible (decoders
ignore unknown frame names; unknown KINDS are an error) and must NOT
bump the version. A decoder seeing a version it does not speak raises
:class:`WireVersionError` — a typed error the server answers with a
clean 400, never a crash — so a mixed-version fleet fails request by
request, loudly, instead of corrupting tensors. A bump is made in both
packages at once; the JAX package's byte goldens
(tests/test_wire_fixtures.py) and the port's byte comparison pin it.

Version history
---------------
- **1** — the original PLAN_REQUEST / PLAN_REPLY / PACKED_DELTA / ERROR
  layout. Still fully decodable (``SUPPORTED_VERSIONS``): a version-1
  payload from an un-upgraded agent plans exactly as before, and the
  service answers it in version 1 (the reply mirrors the request's
  version), so a mixed-version fleet interoperates without flag days.
- **2** — tick tracing (docs/OBSERVABILITY.md): PLAN_REQUEST may carry
  an optional ``trace_id`` frame (the agent's tick trace ID, also sent
  as ``X-Trace-Id``), and PLAN_REPLY may carry three optional span
  frames (``span_names``/``span_t0_ms``/``span_dur_ms``) returning the
  server-side spans — queue-wait, batch assembly, solve, ... — the
  agent grafts into its tick trace. All trace frames are optional:
  their absence is a valid version-2 message. The bump (rather than
  frame addition alone) marks the reply-mirroring contract: a v2-aware
  peer may rely on span frames surviving the round trip.
- **3** — drain schedules (solver/schedule.py): PLAN_REQUEST may carry
  an optional ``schedule_horizon`` frame asking the service to answer
  with a whole drain-to-exhaustion schedule, and a NEW reply kind
  ``KIND_PLAN_SCHEDULE`` carries it (one ``steps`` int32
  ``[horizon, 3+K]`` matrix — the same layout the in-process device
  fetch returns — plus the PLAN_REPLY batch telemetry and optional v2
  span frames). Per the policy above, the new kind and frame alone
  would not bump the version; the bump marks the REPLY-KIND contract:
  only a version-3 request may be answered with KIND_PLAN_SCHEDULE
  (the reply mirrors the request's version, so v1/v2 agents can never
  receive a kind they do not decode), and a v3-aware peer may rely on
  the service honoring ``schedule_horizon``.
- **4** — the delta wire (docs/ROBUSTNESS.md "Wire anti-entropy"):
  ``KIND_PACKED_DELTA`` — shipped by nothing before this version —
  becomes a REAL plan request: it must carry ``base_fingerprint`` (the
  pack the delta diffs from), ``new_fingerprint`` (the pack it
  produces) and ``delta_digest`` (sha256 over both fingerprints and
  every delta tensor — verified at decode, so a corrupted-in-flight
  delta is a typed error, never wrong tensors), and may carry the v2
  ``trace_id``. PLAN_REQUEST may carry an optional
  ``pack_fingerprint`` frame seeding the service's tenant cache. A NEW
  reply kind ``KIND_RESYNC`` answers a delta whose base the service
  cannot honor (restart, eviction, fingerprint mismatch, any
  decode/apply anomaly): a ``cause`` string demanding one full-pack
  resync. The bump marks the reply-kind contract once more: only a
  version-4 delta request may be answered with KIND_RESYNC, and a
  pre-v4 KIND_PACKED_DELTA (which nothing ever sent) is refused at
  decode — it carries no fingerprints, so it can neither be verified
  nor answered with a resync the sender would decode.
"""

from __future__ import annotations

import hashlib
import struct
from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np

MAGIC = b"KSRW"
WIRE_VERSION = 4
SUPPORTED_VERSIONS = (1, 2, 3, 4)

# message kinds (u8). New kinds append; renumbering is a version bump.
KIND_PLAN_REQUEST = 1  # agent -> service: tenant + PackedCluster
KIND_PLAN_REPLY = 2  # service -> agent: selection + batch telemetry
KIND_PACKED_DELTA = 3  # agent -> service: tenant + PackedDelta (v4)
KIND_ERROR = 4  # service -> agent: typed error text
KIND_PLAN_SCHEDULE = 5  # service -> agent: whole drain schedule (v3)
KIND_RESYNC = 6  # service -> agent: delta base unusable; full pack (v4)

# dtype table (u8 code <-> numpy dtype). Append-only; reordering is a
# version bump. bool travels as its own code (1 byte/element) so the
# decoder can hand back real bool arrays, not u8 lookalikes.
_DTYPE_CODES: Tuple[np.dtype, ...] = tuple(
    np.dtype(d) for d in ("<f4", "<i4", "<i8", "<u4", "u1", "?")
)
_CODE_OF: Dict[np.dtype, int] = {d: i for i, d in enumerate(_DTYPE_CODES)}

_HEADER = struct.Struct("<4sBBH")
_FRAME_HEAD = struct.Struct("<H")
_FRAME_TAG = struct.Struct("<BB")
_DIM = struct.Struct("<I")
_PAYLEN = struct.Struct("<Q")

# hard ceilings a hostile or corrupt message cannot talk past: the
# decoder rejects before allocating (ndim is bounded by the tensor
# model; 255 frames is far above any real message's dozen)
MAX_NDIM = 8
MAX_FRAMES = 255


class WireError(ValueError):
    """Malformed or out-of-contract wire bytes (typed; never a crash)."""


class WireVersionError(WireError):
    """The message speaks a protocol version this decoder does not."""


def _encode_frame(name: str, arr: np.ndarray) -> bytes:
    arr = np.asarray(arr)
    if arr.dtype.byteorder == ">":
        # actually swap a big-endian input to the wire order — mapping
        # the dtype code alone would tag byte-reversed payloads as
        # little-endian, silent corruption on the far side
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    code = _CODE_OF.get(arr.dtype)
    if code is None:
        raise WireError(f"dtype {arr.dtype} has no wire code (frame {name!r})")
    payload = np.ascontiguousarray(arr).tobytes()
    nb = name.encode("utf-8")
    parts = [
        _FRAME_HEAD.pack(len(nb)),
        nb,
        _FRAME_TAG.pack(code, arr.ndim),
    ]
    parts.extend(_DIM.pack(d) for d in arr.shape)
    parts.append(_PAYLEN.pack(len(payload)))
    parts.append(payload)
    return b"".join(parts)


def encode_frames(
    kind: int,
    frames: List[Tuple[str, np.ndarray]],
    version: Optional[int] = None,
) -> bytes:
    """One wire message: header + the given (name, array) frames, in
    the given order (the order is part of the byte-golden contract).
    ``version`` defaults to ``WIRE_VERSION``; the server passes the
    REQUEST's version so an un-upgraded agent can decode its reply."""
    version = WIRE_VERSION if version is None else int(version)
    if version not in SUPPORTED_VERSIONS:
        raise WireError(f"cannot encode unsupported wire version {version}")
    if len(frames) > MAX_FRAMES:
        raise WireError(f"{len(frames)} frames exceeds the {MAX_FRAMES} cap")
    out = [_HEADER.pack(MAGIC, version, kind, len(frames))]
    out.extend(_encode_frame(n, a) for n, a in frames)
    return b"".join(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def take(self, n: int, what: str) -> bytes:
        if self.pos + n > len(self.data):
            raise WireError(
                f"truncated message: {what} needs {n} bytes, "
                f"{len(self.data) - self.pos} remain"
            )
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out


def decode_frames(data: bytes) -> Tuple[int, Dict[str, np.ndarray]]:
    """(kind, {name: array}) or a typed WireError; see
    :func:`decode_frames_v` for the variant that also reports the
    message's protocol version."""
    _, kind, frames = decode_frames_v(data)
    return kind, frames


def decode_frames_v(data: bytes) -> Tuple[int, int, Dict[str, np.ndarray]]:
    """(version, kind, {name: array}) or a typed WireError. Arrays are
    zero-copy views into ``data`` (read-only) — the solve path only
    reads them. Every version in ``SUPPORTED_VERSIONS`` decodes (a
    version-1 payload from an un-upgraded agent simply carries no trace
    frames); anything else is a clean :class:`WireVersionError`."""
    r = _Reader(bytes(data) if isinstance(data, (bytearray, memoryview)) else data)
    magic, version, kind, n_frames = _HEADER.unpack(r.take(_HEADER.size, "header"))
    if magic != MAGIC:
        raise WireError(f"bad magic {magic!r} (not a planner wire message)")
    if version not in SUPPORTED_VERSIONS:
        raise WireVersionError(
            f"wire version {version} not supported (this build speaks "
            f"{sorted(SUPPORTED_VERSIONS)}; see the version bump policy "
            "in service/wire.py)"
        )
    if kind not in (
        KIND_PLAN_REQUEST, KIND_PLAN_REPLY, KIND_PACKED_DELTA, KIND_ERROR,
        KIND_PLAN_SCHEDULE, KIND_RESYNC,
    ):
        raise WireError(f"unknown message kind {kind}")
    if n_frames > MAX_FRAMES:
        raise WireError(f"{n_frames} frames exceeds the {MAX_FRAMES} cap")
    frames: Dict[str, np.ndarray] = {}
    for _ in range(n_frames):
        (name_len,) = _FRAME_HEAD.unpack(r.take(_FRAME_HEAD.size, "frame name length"))
        try:
            name = r.take(name_len, "frame name").decode("utf-8")
        except UnicodeDecodeError as err:
            # found by the fuzz corpus: a corrupted name byte must be a
            # typed WireError (clean 400), not a raw UnicodeDecodeError
            raise WireError(f"frame name is not valid utf-8: {err}") from err
        if name in frames:
            raise WireError(f"duplicate frame {name!r}")
        code, ndim = _FRAME_TAG.unpack(r.take(_FRAME_TAG.size, "frame tag"))
        if code >= len(_DTYPE_CODES):
            raise WireError(f"unknown dtype code {code} (frame {name!r})")
        if ndim > MAX_NDIM:
            raise WireError(f"frame {name!r} rank {ndim} exceeds {MAX_NDIM}")
        shape = tuple(
            _DIM.unpack(r.take(_DIM.size, f"{name} dim"))[0] for _ in range(ndim)
        )
        (paylen,) = _PAYLEN.unpack(r.take(_PAYLEN.size, "payload length"))
        dtype = _DTYPE_CODES[code]
        # exact Python-int arithmetic: an np.prod here would wrap on
        # crafted u32 dims and let paylen=0 sail past the check
        want = dtype.itemsize
        for d in shape:
            want *= int(d)
        if paylen != want:
            raise WireError(
                f"frame {name!r}: payload {paylen} bytes != shape "
                f"{shape} x {dtype} = {want}"
            )
        payload = r.take(paylen, f"{name} payload")
        frames[name] = np.frombuffer(payload, dtype).reshape(shape)
    if r.pos != len(r.data):
        raise WireError(f"{len(r.data) - r.pos} trailing bytes after last frame")
    return version, kind, frames


# ---------------------------------------------------------------------------
# PackedCluster / PackedDelta messages

# the wire dtype contract per tensor field — the same pack contract the
# PackedCluster docstring pins; the decoder REJECTS a frame whose dtype
# disagrees instead of silently casting (a u8-cast bool mask would solve
# the wrong problem without erroring anywhere downstream)
_PACKED_DTYPES = {
    "slot_req": np.dtype("<f4"),
    "slot_valid": np.dtype("?"),
    "slot_tol": np.dtype("<u4"),
    "slot_aff": np.dtype("<u4"),
    "cand_valid": np.dtype("?"),
    "spot_free": np.dtype("<f4"),
    "spot_count": np.dtype("<i4"),
    "spot_max_pods": np.dtype("<i4"),
    "spot_taints": np.dtype("<u4"),
    "spot_ok": np.dtype("?"),
    "spot_aff": np.dtype("<u4"),
}

_DELTA_DTYPES = {
    "lanes": np.dtype("<i4"),
    "lane_slot_req": np.dtype("<f4"),
    "lane_slot_valid": np.dtype("?"),
    "lane_slot_tol": np.dtype("<u4"),
    "lane_slot_aff": np.dtype("<u4"),
    "cand_rows": np.dtype("<i4"),
    "cand_valid": np.dtype("?"),
    "spot_rows": np.dtype("<i4"),
    "spot_free": np.dtype("<f4"),
    "spot_count": np.dtype("<i4"),
    "spot_max_pods": np.dtype("<i4"),
    "spot_taints": np.dtype("<u4"),
    "spot_ok": np.dtype("?"),
    "spot_aff": np.dtype("<u4"),
}

_PACKED_RANKS = {
    "slot_req": 3, "slot_valid": 2, "slot_tol": 3, "slot_aff": 3,
    "cand_valid": 1, "spot_free": 2, "spot_count": 1, "spot_max_pods": 1,
    "spot_taints": 2, "spot_ok": 1, "spot_aff": 2,
}


def _str_frame(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), np.uint8)


def _frame_str(arr: np.ndarray, what: str) -> str:
    try:
        return bytes(np.asarray(arr, np.uint8)).decode("utf-8")
    except UnicodeDecodeError as err:
        raise WireError(f"{what} is not valid utf-8: {err}") from err


def encode_plan_request(
    tenant: str,
    packed,
    trace_id: str = "",
    version: Optional[int] = None,
    schedule_horizon: int = 0,
    pack_fingerprint: str = "",
) -> bytes:
    """Agent -> service: one tenant's full packed problem, optionally
    stamped with the agent's tick trace ID (wire v2; omitted when empty
    or when encoding a version-1 message for an old server), an
    optional ``schedule_horizon`` (wire v3: ask for a whole drain
    schedule back — KIND_PLAN_SCHEDULE — instead of a single plan),
    and an optional ``pack_fingerprint`` (wire v4: seed the service's
    tenant cache so the NEXT tick may ship a delta)."""
    version = WIRE_VERSION if version is None else int(version)
    frames: List[Tuple[str, np.ndarray]] = [("tenant", _str_frame(tenant))]
    frames.extend((f, getattr(packed, f)) for f in type(packed)._fields)
    if trace_id and version >= 2:
        frames.append(("trace_id", _str_frame(trace_id)))
    if schedule_horizon > 0 and version >= 3:
        frames.append(
            ("schedule_horizon", np.array([schedule_horizon], "<i4"))
        )
    if pack_fingerprint and version >= 4:
        frames.append(("pack_fingerprint", _str_frame(pack_fingerprint)))
    return encode_frames(KIND_PLAN_REQUEST, frames, version=version)


def _check_tensor_fields(frames, dtypes, ranks, what):
    out = {}
    for name, dtype in dtypes.items():
        arr = frames.get(name)
        if arr is None:
            raise WireError(f"{what} missing tensor frame {name!r}")
        if arr.dtype != dtype:
            raise WireError(
                f"{what} frame {name!r}: dtype {arr.dtype} != contract {dtype}"
            )
        rank = ranks.get(name)
        if rank is not None and arr.ndim != rank:
            raise WireError(
                f"{what} frame {name!r}: rank {arr.ndim} != contract {rank}"
            )
        out[name] = arr
    return out


class PlanRequest(NamedTuple):
    """A fully-decoded plan request: its protocol version (the reply
    mirrors it), tenant, problem tensors, the optional trace ID, the
    optional drain-schedule horizon (0 = an ordinary single-plan
    request; > 0 = answer with KIND_PLAN_SCHEDULE, wire v3), and the
    optional pack fingerprint (wire v4: seed the tenant cache; empty =
    the agent does not speak the delta wire)."""

    version: int
    tenant: str
    packed: object  # PackedCluster
    trace_id: str
    schedule_horizon: int = 0
    pack_fingerprint: str = ""


def decode_plan_request(data: bytes):
    """(tenant, PackedCluster) from KIND_PLAN_REQUEST bytes; see
    :func:`decode_plan_request_ex` for version + trace metadata."""
    req = decode_plan_request_ex(data)
    return req.tenant, req.packed


def decode_plan_request_ex(data: bytes) -> PlanRequest:
    """Full decode of KIND_PLAN_REQUEST bytes; every tensor's dtype and
    rank is checked against the pack contract, and the cross-field
    shape consistency (shared C/K/S/R/W/A dims) is verified — a request
    that decodes is safe to pad, stack and solve. The ``trace_id`` is
    empty for version-1 payloads (or when the agent sent none)."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster

    version, kind, frames = decode_frames_v(data)
    if kind != KIND_PLAN_REQUEST:
        raise WireError(f"expected PLAN_REQUEST, got kind {kind}")
    tenant = _frame_str(frames.get("tenant", np.zeros(0, np.uint8)), "tenant id")
    if not tenant:
        raise WireError("plan request carries no tenant id")
    trace_id = ""
    if "trace_id" in frames:
        trace_id = _frame_str(frames["trace_id"], "trace id")
    schedule_horizon = 0
    if "schedule_horizon" in frames:
        if version < 3:
            # reject at DECODE (clean 400), not after a batch solve:
            # only a v3 request may be answered with KIND_PLAN_SCHEDULE
            # (the version-bump contract above), so a pre-v3 request
            # carrying the frame is out of contract, and honoring it
            # would burn a whole schedule solve only to fail at encode
            raise WireError(
                f"schedule_horizon frame requires wire version >= 3 "
                f"(request is version {version})"
            )
        schedule_horizon = int(
            _scalar(frames, "schedule_horizon", "<i4", "plan request")
        )
        if schedule_horizon < 1:
            raise WireError(
                f"plan request schedule_horizon {schedule_horizon} "
                "must be >= 1 when present"
            )
    pack_fingerprint = ""
    if "pack_fingerprint" in frames:
        if version < 4:
            # same contract as schedule_horizon above: the frame's
            # meaning (cache seeding + the KIND_RESYNC answer path) is
            # a v4 contract; a pre-v4 request carrying it is out of
            # contract and refused at decode (clean 400)
            raise WireError(
                f"pack_fingerprint frame requires wire version >= 4 "
                f"(request is version {version})"
            )
        pack_fingerprint = _frame_str(
            frames["pack_fingerprint"], "pack fingerprint"
        )
    t = _check_tensor_fields(frames, _PACKED_DTYPES, _PACKED_RANKS, "plan request")
    C, K, R = t["slot_req"].shape
    S = t["spot_free"].shape[0]
    W = t["spot_taints"].shape[1]
    A = t["spot_aff"].shape[1]
    expect = {
        "slot_valid": (C, K), "slot_tol": (C, K, W), "slot_aff": (C, K, A),
        "cand_valid": (C,), "spot_free": (S, R), "spot_count": (S,),
        "spot_max_pods": (S,), "spot_taints": (S, W), "spot_ok": (S,),
        "spot_aff": (S, A),
    }
    for name, shape in expect.items():
        if t[name].shape != shape:
            raise WireError(
                f"plan request frame {name!r}: shape {t[name].shape} "
                f"inconsistent with (C={C}, K={K}, S={S}, R={R}, W={W}, "
                f"A={A}) — expected {shape}"
            )
    return PlanRequest(
        version, tenant, PackedCluster(**t), trace_id, schedule_horizon,
        pack_fingerprint,
    )


def delta_digest(base_fingerprint: str, new_fingerprint: str, delta) -> str:
    """Integrity digest of one delta message: sha256 over both
    fingerprints and every delta tensor's shape + little-endian bytes.
    Computed by the encoder and REVERIFIED at decode — a bit flipped
    anywhere in the fingerprints or the churn payload is a typed
    :class:`WireError` (the service answers with a resync demand),
    never silently-wrong tensors scattered into a tenant's cached
    state. O(churn) to compute, like the delta itself. The per-tensor
    hash step is models/delta.update_tensor_digest — the SAME
    routine behind pack_fingerprint, so the two sides of the
    anti-entropy protocol can never drift apart."""
    from k8s_spot_rescheduler_tpu_torch.models.delta import (
        update_tensor_digest,
    )

    h = hashlib.sha256()
    h.update(base_fingerprint.encode("utf-8"))
    h.update(new_fingerprint.encode("utf-8"))
    for f in type(delta)._fields:
        update_tensor_digest(h, f, getattr(delta, f))
    return h.hexdigest()


def encode_packed_delta(
    tenant: str,
    delta,
    version: Optional[int] = None,
    *,
    base_fingerprint: str = "",
    new_fingerprint: str = "",
    trace_id: str = "",
) -> bytes:
    """Agent -> service: a churn-proportional PackedDelta — since wire
    v4 a real plan request carrying the base/new pack fingerprints and
    an integrity digest (see :func:`delta_digest`). Encoding for a
    pre-v4 version drops the fingerprint/digest/trace frames (the
    additive-bump proof: pre-v4 bytes stay exactly what those builds
    shipped); encoding v4 REQUIRES both fingerprints — a v4 delta
    without them could be neither verified nor safely applied."""
    version = WIRE_VERSION if version is None else int(version)
    frames: List[Tuple[str, np.ndarray]] = [("tenant", _str_frame(tenant))]
    frames.extend((f, getattr(delta, f)) for f in type(delta)._fields)
    if version >= 4:
        if not base_fingerprint or not new_fingerprint:
            raise WireError(
                "a version-4 packed delta requires base_fingerprint "
                "and new_fingerprint"
            )
        frames.append(("base_fingerprint", _str_frame(base_fingerprint)))
        frames.append(("new_fingerprint", _str_frame(new_fingerprint)))
        frames.append((
            "delta_digest",
            _str_frame(
                delta_digest(base_fingerprint, new_fingerprint, delta)
            ),
        ))
        if trace_id:
            frames.append(("trace_id", _str_frame(trace_id)))
    return encode_frames(KIND_PACKED_DELTA, frames, version=version)


class DeltaRequest(NamedTuple):
    """A fully-decoded (and digest-verified) delta plan request."""

    version: int
    tenant: str
    delta: object  # PackedDelta
    base_fingerprint: str
    new_fingerprint: str
    trace_id: str = ""


def decode_packed_delta(data: bytes):
    """(tenant, PackedDelta) from KIND_PACKED_DELTA bytes; see
    :func:`decode_packed_delta_ex` for the fingerprints."""
    req = decode_packed_delta_ex(data)
    return req.tenant, req.delta


def decode_packed_delta_ex(data: bytes) -> DeltaRequest:
    """Full decode of KIND_PACKED_DELTA bytes. Requires wire version
    >= 4 (nothing ever sent the kind before v4, and a pre-v4 delta
    carries no fingerprints — unverifiable, and its sender could not
    decode the KIND_RESYNC answer); verifies the delta digest, so a
    message that decodes is bit-exact as sent."""
    from k8s_spot_rescheduler_tpu_torch.models.delta import PackedDelta

    version, kind, frames = decode_frames_v(data)
    if kind != KIND_PACKED_DELTA:
        raise WireError(f"expected PACKED_DELTA, got kind {kind}")
    if version < 4:
        raise WireError(
            f"packed delta over the wire requires version >= 4 "
            f"(request is version {version}; pre-v4 builds never sent "
            "this kind)"
        )
    tenant = _frame_str(frames.get("tenant", np.zeros(0, np.uint8)), "tenant id")
    if not tenant:
        raise WireError("packed delta carries no tenant id")
    base_fp = _frame_str(
        frames.get("base_fingerprint", np.zeros(0, np.uint8)),
        "base fingerprint",
    )
    new_fp = _frame_str(
        frames.get("new_fingerprint", np.zeros(0, np.uint8)),
        "new fingerprint",
    )
    digest = _frame_str(
        frames.get("delta_digest", np.zeros(0, np.uint8)), "delta digest"
    )
    if not base_fp or not new_fp or not digest:
        raise WireError(
            "packed delta missing base_fingerprint / new_fingerprint / "
            "delta_digest frame(s)"
        )
    trace_id = ""
    if "trace_id" in frames:
        trace_id = _frame_str(frames["trace_id"], "trace id")
    t = _check_tensor_fields(frames, _DELTA_DTYPES, {}, "packed delta")
    for sec in (
        ("lanes", "lane_slot_req", "lane_slot_valid", "lane_slot_tol",
         "lane_slot_aff"),
        ("cand_rows", "cand_valid"),
        ("spot_rows", "spot_free", "spot_count", "spot_max_pods",
         "spot_taints", "spot_ok", "spot_aff"),
    ):
        n = t[sec[0]].shape[0]
        for name in sec[1:]:
            if t[name].shape[0] != n:
                raise WireError(
                    f"packed delta frame {name!r}: leading dim "
                    f"{t[name].shape[0]} != section length {n}"
                )
    delta = PackedDelta(**t)
    want = delta_digest(base_fp, new_fp, delta)
    if digest != want:
        raise WireError(
            "packed delta digest mismatch (message corrupted in "
            "flight); a full-pack resync is required"
        )
    return DeltaRequest(version, tenant, delta, base_fp, new_fp, trace_id)


class ResyncDemand(NamedTuple):
    """Service -> agent (KIND_RESYNC, v4): the delta's base state is
    unusable server-side — restart, cache eviction, fingerprint
    mismatch, or a decode/apply anomaly. ``cause`` says which; the
    agent answers with exactly one full-pack request."""

    cause: str


def encode_resync(cause: str, version: Optional[int] = None) -> bytes:
    version = WIRE_VERSION if version is None else int(version)
    if version < 4:
        raise WireError(
            f"KIND_RESYNC requires wire version >= 4, got {version} "
            "(a pre-v4 peer never sent a delta)"
        )
    return encode_frames(
        KIND_RESYNC, [("cause", _str_frame(cause))], version=version
    )


def decode_resync(data: bytes) -> ResyncDemand:
    kind, frames = decode_frames(data)
    if kind != KIND_RESYNC:
        raise WireError(f"expected RESYNC, got kind {kind}")
    return ResyncDemand(
        _frame_str(frames.get("cause", np.zeros(0, np.uint8)), "resync cause")
    )


def decode_plan_or_resync(data: bytes):
    """The decoder a delta-shipping agent applies to a delta request's
    answer: a :class:`PlanReply` (the delta applied and rode a batch)
    or a :class:`ResyncDemand` (send one full pack). Anything else is
    a typed WireError like every other out-of-contract reply."""
    kind, frames = decode_frames(data)
    if kind == KIND_RESYNC:
        return ResyncDemand(
            _frame_str(
                frames.get("cause", np.zeros(0, np.uint8)), "resync cause"
            )
        )
    return decode_plan_reply(data)


# ---------------------------------------------------------------------------
# plan reply

class PlanReply(NamedTuple):
    """The selection + batch telemetry one plan request gets back —
    deliberately the same few hundred bytes the in-process device
    boundary fetches (solver/select.Selection), plus what the agent's
    metrics need to see about the batch it rode in. ``spans`` (wire v2)
    carries the server-side trace spans as flat
    ``(name, t0_ms, dur_ms)`` tuples the agent grafts into its tick
    trace; empty on version-1 replies."""

    found: bool
    index: int
    n_feasible: int
    row: np.ndarray  # int32 [K]
    solve_ms: float  # the batched device solve, amortized share
    queue_wait_ms: float  # this request's time in the tenant queue
    batch_lanes: int  # candidate lanes in the batch it rode in
    batch_tenants: int  # tenant lane-blocks sharing that batch
    spans: Tuple[Tuple[str, float, float], ...] = ()


def encode_plan_reply(reply: PlanReply, version: Optional[int] = None) -> bytes:
    version = WIRE_VERSION if version is None else int(version)
    frames = [
        ("found", np.array([reply.found], np.uint8)),
        ("index", np.array([reply.index], "<i4")),
        ("n_feasible", np.array([reply.n_feasible], "<i4")),
        ("row", np.ascontiguousarray(np.asarray(reply.row, "<i4"))),
        ("solve_ms", np.array([reply.solve_ms], "<f4")),
        ("queue_wait_ms", np.array([reply.queue_wait_ms], "<f4")),
        ("batch_lanes", np.array([reply.batch_lanes], "<i4")),
        ("batch_tenants", np.array([reply.batch_tenants], "<i4")),
    ]
    if reply.spans and version >= 2:
        # the compact server-span block: newline-joined names + two
        # parallel f4 vectors. Names come from utils/tracing.SPAN_NAMES
        # (never cluster-derived strings) so the frame stays both small
        # and redaction-clean.
        names = [s[0] for s in reply.spans]
        if any("\n" in n for n in names):
            raise WireError("span names must not contain newlines")
        frames.append(("span_names", _str_frame("\n".join(names))))
        frames.append(
            ("span_t0_ms", np.asarray([s[1] for s in reply.spans], "<f4"))
        )
        frames.append(
            ("span_dur_ms", np.asarray([s[2] for s in reply.spans], "<f4"))
        )
    return encode_frames(KIND_PLAN_REPLY, frames, version=version)


def _scalar(frames, name, dtype, what):
    arr = frames.get(name)
    if arr is None or arr.dtype != np.dtype(dtype) or arr.size != 1:
        raise WireError(f"{what} frame {name!r} missing or malformed")
    return arr.reshape(())[()]


def _decode_reply_spans(frames) -> Tuple[Tuple[str, float, float], ...]:
    """The optional server-span block of a v2 reply; () when absent.
    Malformed span frames are a WireError like any other frame — a
    reply that claims spans must carry a coherent block."""
    names_frame = frames.get("span_names")
    if names_frame is None:
        return ()
    names = _frame_str(names_frame, "span names").split("\n")
    t0 = frames.get("span_t0_ms")
    dur = frames.get("span_dur_ms")
    for name, arr in (("span_t0_ms", t0), ("span_dur_ms", dur)):
        if arr is None or arr.dtype != np.dtype("<f4") or arr.ndim != 1 \
                or arr.size != len(names):
            raise WireError(f"plan reply frame {name!r} missing or malformed")
    return tuple(
        (names[i], float(t0[i]), float(dur[i])) for i in range(len(names))
    )


def decode_plan_reply(data: bytes) -> PlanReply:
    kind, frames = decode_frames(data)
    if kind == KIND_ERROR:
        raise WireError(
            "service error: "
            + _frame_str(frames.get("message", np.zeros(0, np.uint8)), "error")
        )
    if kind != KIND_PLAN_REPLY:
        raise WireError(f"expected PLAN_REPLY, got kind {kind}")
    row = frames.get("row")
    if row is None or row.dtype != np.dtype("<i4") or row.ndim != 1:
        raise WireError("plan reply frame 'row' missing or malformed")
    return PlanReply(
        found=bool(_scalar(frames, "found", "u1", "plan reply")),
        index=int(_scalar(frames, "index", "<i4", "plan reply")),
        n_feasible=int(_scalar(frames, "n_feasible", "<i4", "plan reply")),
        row=row,
        solve_ms=float(_scalar(frames, "solve_ms", "<f4", "plan reply")),
        queue_wait_ms=float(
            _scalar(frames, "queue_wait_ms", "<f4", "plan reply")
        ),
        batch_lanes=int(_scalar(frames, "batch_lanes", "<i4", "plan reply")),
        batch_tenants=int(
            _scalar(frames, "batch_tenants", "<i4", "plan reply")
        ),
        spans=_decode_reply_spans(frames),
    )


# ---------------------------------------------------------------------------
# drain-schedule reply (wire v3)

class PlanScheduleReply(NamedTuple):
    """A whole drain schedule for one tenant (KIND_PLAN_SCHEDULE):
    ``steps`` is the int32 ``[horizon, 3 + K]`` matrix the in-process
    device fetch returns (per step ``idx | found | n_feasible | row``;
    decode with ``solver/schedule.decode_schedule``), plus the same
    batch telemetry and optional server-span block a PLAN_REPLY
    carries. Only ever sent in answer to a version-3 request that
    asked via ``schedule_horizon`` (the version-bump contract)."""

    steps: np.ndarray  # int32 [H, 3 + K]
    solve_ms: float
    queue_wait_ms: float
    batch_lanes: int
    batch_tenants: int
    spans: Tuple[Tuple[str, float, float], ...] = ()


def encode_plan_schedule_reply(
    reply: PlanScheduleReply, version: Optional[int] = None
) -> bytes:
    version = WIRE_VERSION if version is None else int(version)
    if version < 3:
        raise WireError(
            f"KIND_PLAN_SCHEDULE requires wire version >= 3, got {version} "
            "(a pre-v3 peer never asked for a schedule)"
        )
    steps = np.ascontiguousarray(np.asarray(reply.steps, "<i4"))
    if steps.ndim != 2 or steps.shape[1] < 3:
        raise WireError(
            f"schedule steps matrix must be [H, 3+K], got {steps.shape}"
        )
    frames = [
        ("steps", steps),
        ("solve_ms", np.array([reply.solve_ms], "<f4")),
        ("queue_wait_ms", np.array([reply.queue_wait_ms], "<f4")),
        ("batch_lanes", np.array([reply.batch_lanes], "<i4")),
        ("batch_tenants", np.array([reply.batch_tenants], "<i4")),
    ]
    if reply.spans:
        names = [s[0] for s in reply.spans]
        if any("\n" in n for n in names):
            raise WireError("span names must not contain newlines")
        frames.append(("span_names", _str_frame("\n".join(names))))
        frames.append(
            ("span_t0_ms", np.asarray([s[1] for s in reply.spans], "<f4"))
        )
        frames.append(
            ("span_dur_ms", np.asarray([s[2] for s in reply.spans], "<f4"))
        )
    return encode_frames(KIND_PLAN_SCHEDULE, frames, version=version)


def decode_plan_schedule_reply(data: bytes) -> PlanScheduleReply:
    kind, frames = decode_frames(data)
    if kind == KIND_ERROR:
        raise WireError(
            "service error: "
            + _frame_str(frames.get("message", np.zeros(0, np.uint8)), "error")
        )
    if kind != KIND_PLAN_SCHEDULE:
        raise WireError(f"expected PLAN_SCHEDULE, got kind {kind}")
    steps = frames.get("steps")
    if (
        steps is None
        or steps.dtype != np.dtype("<i4")
        or steps.ndim != 2
        or steps.shape[1] < 3
    ):
        raise WireError(
            "plan schedule frame 'steps' missing or malformed"
        )
    return PlanScheduleReply(
        steps=steps,
        solve_ms=float(_scalar(frames, "solve_ms", "<f4", "plan schedule")),
        queue_wait_ms=float(
            _scalar(frames, "queue_wait_ms", "<f4", "plan schedule")
        ),
        batch_lanes=int(
            _scalar(frames, "batch_lanes", "<i4", "plan schedule")
        ),
        batch_tenants=int(
            _scalar(frames, "batch_tenants", "<i4", "plan schedule")
        ),
        spans=_decode_reply_spans(frames),
    )


def encode_error(message: str, version: Optional[int] = None) -> bytes:
    """In-protocol error body (rides under an HTTP error status so
    binary clients never have to sniff JSON out of an octet stream).
    ``version`` mirrors the request's when known; version 1 is the safe
    answer to a request whose version could not be read (both old and
    new decoders accept it)."""
    return encode_frames(
        KIND_ERROR, [("message", _str_frame(message))], version=version
    )
