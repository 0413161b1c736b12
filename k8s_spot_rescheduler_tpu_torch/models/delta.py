"""Churn-proportional deltas between two consecutive host packs.

A copy of ``PackedDelta``, ``emit_packed_delta``, ``pad_pow2`` and
``pad_packed_delta`` from the JAX package's ``models/columnar.py``. The
diff is an exact bitwise compare of two numpy packs, so writing the
delta's rows into the previous tick's device tensors reproduces the
new pack bit for bit. The planner (``planner/solver_planner``) writes
the delta unpadded; ``pad_pow2``/``pad_packed_delta`` keep the
reference's padded wire form (index pads one past the axis end).
"""

from __future__ import annotations

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


def pad_packed_delta(delta: PackedDelta, C: int, S: int) -> PackedDelta:
    """Pad each delta section to a power-of-two length; index pads point
    one past the axis end (``C`` for lanes and validity bits, ``S`` for
    spot rows), data pads are zeros."""

    def idx(a, oob):
        out = np.full(pad_pow2(len(a)), oob, np.int32)
        out[: len(a)] = a
        return out

    def data(a):
        out = np.zeros((pad_pow2(a.shape[0]),) + a.shape[1:], a.dtype)
        out[: a.shape[0]] = a
        return out

    return PackedDelta(
        lanes=idx(delta.lanes, C),
        lane_slot_req=data(delta.lane_slot_req),
        lane_slot_valid=data(delta.lane_slot_valid),
        lane_slot_tol=data(delta.lane_slot_tol),
        lane_slot_aff=data(delta.lane_slot_aff),
        cand_rows=idx(delta.cand_rows, C),
        cand_valid=data(delta.cand_valid),
        spot_rows=idx(delta.spot_rows, S),
        spot_free=data(delta.spot_free),
        spot_count=data(delta.spot_count),
        spot_max_pods=data(delta.spot_max_pods),
        spot_taints=data(delta.spot_taints),
        spot_ok=data(delta.spot_ok),
        spot_aff=data(delta.spot_aff),
    )
