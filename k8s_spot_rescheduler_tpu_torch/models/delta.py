"""Churn-proportional deltas between two consecutive host packs.

A copy of ``PackedDelta``, ``emit_packed_delta``, ``pad_pow2``,
``pad_packed_delta``, ``empty_packed_delta``, ``update_tensor_digest``
and ``pack_fingerprint`` from the JAX package's ``models/columnar.py``.
The diff is an exact bitwise compare of two numpy packs, so writing the
delta's rows into the previous tick's device tensors reproduces the
new pack bit for bit. The planner (``planner/solver_planner``) writes
the delta unpadded; ``pad_pow2``/``pad_packed_delta`` keep the
reference's padded wire form (index pads one past the axis end), which
the planner service stacks per batch (``parallel/tenant_batch.
apply_tenant_deltas``). ``pack_fingerprint`` is the delta wire's content
key (``service/wire.py`` v4), hashed as the JAX package hashes it.
"""

from __future__ import annotations

import hashlib
from typing import NamedTuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster


class PackedDelta(NamedTuple):
    """Churn-proportional update between two same-shape PackedClusters."""

    # changed candidate lanes (full [K, ·] slabs, lane-major)
    lanes: np.ndarray  # i32 [L]
    lane_slot_req: np.ndarray  # f32 [L, K, R]
    lane_slot_valid: np.ndarray  # bool [L, K]
    lane_slot_tol: np.ndarray  # u32 [L, K, W]
    lane_slot_aff: np.ndarray  # u32 [L, K, A]
    # changed per-lane validity bits
    cand_rows: np.ndarray  # i32 [Lc]
    cand_valid: np.ndarray  # bool [Lc]
    # changed spot rows
    spot_rows: np.ndarray  # i32 [M]
    spot_free: np.ndarray  # f32 [M, R]
    spot_count: np.ndarray  # i32 [M]
    spot_max_pods: np.ndarray  # i32 [M]
    spot_taints: np.ndarray  # u32 [M, W]
    spot_ok: np.ndarray  # bool [M]
    spot_aff: np.ndarray  # u32 [M, A]

    @property
    def nbytes(self) -> int:
        """Bytes this delta ships host→device (unpadded)."""
        return sum(np.asarray(f).nbytes for f in self)

    @property
    def n_lanes(self) -> int:
        return len(self.lanes)


# packed field <- (delta index section, delta data section): where each
# delta section lands when a delta is written into a state
DELTA_FIELDS = (
    ("slot_req", "lanes", "lane_slot_req"),
    ("slot_valid", "lanes", "lane_slot_valid"),
    ("slot_tol", "lanes", "lane_slot_tol"),
    ("slot_aff", "lanes", "lane_slot_aff"),
    ("cand_valid", "cand_rows", "cand_valid"),
    ("spot_free", "spot_rows", "spot_free"),
    ("spot_count", "spot_rows", "spot_count"),
    ("spot_max_pods", "spot_rows", "spot_max_pods"),
    ("spot_taints", "spot_rows", "spot_taints"),
    ("spot_ok", "spot_rows", "spot_ok"),
    ("spot_aff", "spot_rows", "spot_aff"),
)


def emit_packed_delta(prev: PackedCluster, new: PackedCluster):
    """Diff two consecutive host packs into a :class:`PackedDelta`.

    Returns None when any tensor shape differs (the cluster outgrew the
    high-water pad floors): the caller must re-upload in full. An
    identical pack yields an all-empty delta (zero upload).
    """
    for f in PackedCluster._fields:
        if getattr(prev, f).shape != getattr(new, f).shape:
            return None
    lane_changed = (
        np.any(prev.slot_req != new.slot_req, axis=(1, 2))
        | np.any(prev.slot_valid != new.slot_valid, axis=1)
        | np.any(prev.slot_tol != new.slot_tol, axis=(1, 2))
        | np.any(prev.slot_aff != new.slot_aff, axis=(1, 2))
    )
    lanes = np.nonzero(lane_changed)[0].astype(np.int32)
    cand_rows = np.nonzero(prev.cand_valid != new.cand_valid)[0].astype(
        np.int32
    )
    spot_changed = (
        np.any(prev.spot_free != new.spot_free, axis=1)
        | (prev.spot_count != new.spot_count)
        | (prev.spot_max_pods != new.spot_max_pods)
        | np.any(prev.spot_taints != new.spot_taints, axis=1)
        | (prev.spot_ok != new.spot_ok)
        | np.any(prev.spot_aff != new.spot_aff, axis=1)
    )
    spot_rows = np.nonzero(spot_changed)[0].astype(np.int32)
    return PackedDelta(
        lanes=lanes,
        lane_slot_req=np.ascontiguousarray(new.slot_req[lanes]),
        lane_slot_valid=np.ascontiguousarray(new.slot_valid[lanes]),
        lane_slot_tol=np.ascontiguousarray(new.slot_tol[lanes]),
        lane_slot_aff=np.ascontiguousarray(new.slot_aff[lanes]),
        cand_rows=cand_rows,
        cand_valid=np.ascontiguousarray(new.cand_valid[cand_rows]),
        spot_rows=spot_rows,
        spot_free=np.ascontiguousarray(new.spot_free[spot_rows]),
        spot_count=np.ascontiguousarray(new.spot_count[spot_rows]),
        spot_max_pods=np.ascontiguousarray(new.spot_max_pods[spot_rows]),
        spot_taints=np.ascontiguousarray(new.spot_taints[spot_rows]),
        spot_ok=np.ascontiguousarray(new.spot_ok[spot_rows]),
        spot_aff=np.ascontiguousarray(new.spot_aff[spot_rows]),
    )


def pad_pow2(n: int) -> int:
    """Round a delta section's length up to a power of two (at least 8),
    so the set of upload shapes stays O(log(max churn))."""
    return 8 if n <= 8 else 1 << (n - 1).bit_length()


def pad_packed_delta(
    delta: PackedDelta,
    C: int,
    S: int,
    *,
    lane_rows: int = 0,
    cand_rows: int = 0,
    spot_rows: int = 0,
    K: int = 0,
) -> PackedDelta:
    """Pad each delta section to a power-of-two length, or to the given
    row counts (the service pads a batch's deltas to one shape); index
    pads point one past the axis end (``C`` for lanes and validity bits,
    ``S`` for spot rows), data pads are zeros. ``K`` past the slab width
    zero-pads the lane slabs' slot axis, as a bucket-padded state's pad
    slot columns are zeros."""

    def idx(a, oob, rows):
        out = np.full(rows or pad_pow2(len(a)), oob, np.int32)
        out[: len(a)] = a
        return out

    def data(a, rows):
        out = np.zeros((rows or pad_pow2(a.shape[0]),) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    def slab(a, rows):
        out = np.zeros(
            (rows or pad_pow2(a.shape[0]), max(K, a.shape[1])) + a.shape[2:],
            a.dtype,
        )
        out[: a.shape[0], : a.shape[1]] = a
        return out

    return PackedDelta(
        lanes=idx(delta.lanes, C, lane_rows),
        lane_slot_req=slab(delta.lane_slot_req, lane_rows),
        lane_slot_valid=slab(delta.lane_slot_valid, lane_rows),
        lane_slot_tol=slab(delta.lane_slot_tol, lane_rows),
        lane_slot_aff=slab(delta.lane_slot_aff, lane_rows),
        cand_rows=idx(delta.cand_rows, C, cand_rows),
        cand_valid=data(delta.cand_valid, cand_rows),
        spot_rows=idx(delta.spot_rows, S, spot_rows),
        spot_free=data(delta.spot_free, spot_rows),
        spot_count=data(delta.spot_count, spot_rows),
        spot_max_pods=data(delta.spot_max_pods, spot_rows),
        spot_taints=data(delta.spot_taints, spot_rows),
        spot_ok=data(delta.spot_ok, spot_rows),
        spot_aff=data(delta.spot_aff, spot_rows),
    )


def empty_packed_delta(packed_or_delta) -> PackedDelta:
    """An all-empty delta at another pack's or delta's trailing dims:
    the no-op scatter a full-pack tenant rides in a mixed batch."""
    src = packed_or_delta
    if isinstance(src, PackedDelta):
        K, R = src.lane_slot_req.shape[1:3]
        W = src.lane_slot_tol.shape[2]
        A = src.lane_slot_aff.shape[2]
    else:
        _, K, R = src.slot_req.shape
        W = src.spot_taints.shape[1]
        A = src.spot_aff.shape[1]
    return PackedDelta(
        lanes=np.zeros(0, np.int32),
        lane_slot_req=np.zeros((0, K, R), np.float32),
        lane_slot_valid=np.zeros((0, K), bool),
        lane_slot_tol=np.zeros((0, K, W), np.uint32),
        lane_slot_aff=np.zeros((0, K, A), np.uint32),
        cand_rows=np.zeros(0, np.int32),
        cand_valid=np.zeros(0, bool),
        spot_rows=np.zeros(0, np.int32),
        spot_free=np.zeros((0, R), np.float32),
        spot_count=np.zeros(0, np.int32),
        spot_max_pods=np.zeros(0, np.int32),
        spot_taints=np.zeros((0, W), np.uint32),
        spot_ok=np.zeros(0, bool),
        spot_aff=np.zeros((0, A), np.uint32),
    )


def update_tensor_digest(h, name: str, arr) -> None:
    """Feed one named tensor into a running sha256: field name, shape
    and little-endian contiguous bytes; the one tensor-hash step of
    ``pack_fingerprint`` and ``service/wire.delta_digest``, byte for
    byte the JAX package's."""
    arr = np.asarray(arr)
    if arr.dtype.byteorder == ">":
        arr = arr.astype(arr.dtype.newbyteorder("<"))
    h.update(name.encode())
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())


def pack_fingerprint(packed) -> str:
    """sha256 over every field of a host pack (``update_tensor_digest``):
    the delta wire's key for the pack a delta diffs from."""
    h = hashlib.sha256()
    for f in type(packed)._fields:
        update_tensor_digest(h, f, getattr(packed, f))
    return h.hexdigest()
