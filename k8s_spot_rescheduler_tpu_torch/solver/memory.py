"""Device-memory estimate of the union solve and the dispatch ladder.

A copy of the JAX package's ``solver/memory``: host integer arithmetic
over the packed shapes that gives the same integers. The union carries
per-lane spot state ([C, R, S] consumed, [C, S] count, [C, A, S]
affinity), so its footprint grows with C x S; the ladder picks the
program that fits a device's budget: the single-device union, the
lane-sharded union, the same with spot-chunked repair, the
carry-streamed narrow union, and last the 2-D layout without repair.

With one device ``pick_tier`` always answers ``"single"``; the
carry-streamed block program (``solver/fallback.union_program`` with
``carry_chunks`` >= 1) is what runs on each device of the sharded
tiers. The estimate selects no device: ``device_hbm_budget`` reads the
card's memory only when it is handed a CUDA device.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    NARROW_LAYOUT,
    plane_bytes as carry_plane_bytes_of,
)

# Default device memory when none is read (the JAX package's constant);
# fraction left to the solver after runtime and program overheads.
DEFAULT_HBM_BYTES = 16 * 1024**3
BUDGET_FRACTION = 0.85

# the narrowest spot chunk the chunk pickers return
MIN_REPAIR_CHUNK = 128
MIN_CARRY_CHUNK = MIN_REPAIR_CHUNK


def estimate_union_hbm_breakdown(
    C: int, K: int, S: int, R: int, W: int, A: int,
    repair_spot_chunks: int = 1,
    carry_chunks: int = 0,
    carry_plane_bytes: Optional[int] = None,
) -> dict:
    """Bytes per buffer family of the union solve at these shapes:
    ``carries`` (the per-lane spot state, double-buffered),
    ``temporaries`` (per-step [C, S] planes), ``repair`` (the rounds'
    working set; 0 with ``repair_spot_chunks=0``, divided by the chunk
    count when chunked), ``slots``, ``outputs`` and ``spot_static``.
    ``carry_chunks`` >= 1 models the carry-streamed union: the stacked
    narrow delta state (``carry_plane_bytes`` per (lane, spot), the
    NARROW_LAYOUT's when None) does not divide, the per-step and repair
    terms live one spot chunk at a time."""
    plane = C * S * 4  # one f32/i32 [C, S] plane
    if carry_chunks and carry_chunks >= 1:
        npb = (
            carry_plane_bytes
            if carry_plane_bytes
            else carry_plane_bytes_of(NARROW_LAYOUT, R, A)
        )
        Sc = -(-S // carry_chunks)
        cplane = C * Sc * 4  # one chunk-resident [C, Sc] plane
        return {
            "carries": 2 * npb * C * S,
            "temporaries": 3 * cplane,
            "repair": (
                0
                if repair_spot_chunks == 0
                else (R + 2 * A + 7) * cplane
            ),
            "slots": K * C * (R * 4 + 1 + W * 4 + A * 4),
            "outputs": 2 * C * K * 4,
            "spot_static": S * (R * 4 + 4 + 4 + W * 4 + 1 + A * 4),
        }
    return {
        "carries": 2 * (R + A + 1) * plane,
        "temporaries": 3 * plane,
        "repair": (
            0
            if repair_spot_chunks == 0
            else (R + 2 * A + 7) * plane // repair_spot_chunks
        ),
        "slots": K * C * (R * 4 + 1 + W * 4 + A * 4),
        "outputs": 2 * C * K * 4,
        "spot_static": S * (R * 4 + 4 + 4 + W * 4 + 1 + A * 4),
    }


def estimate_union_hbm_bytes(
    C: int, K: int, S: int, R: int, W: int, A: int,
    repair_spot_chunks: int = 1,
    carry_chunks: int = 0,
    carry_plane_bytes: Optional[int] = None,
) -> int:
    """The sum of ``estimate_union_hbm_breakdown``."""
    return sum(
        estimate_union_hbm_breakdown(
            C, K, S, R, W, A,
            repair_spot_chunks=repair_spot_chunks,
            carry_chunks=carry_chunks,
            carry_plane_bytes=carry_plane_bytes,
        ).values()
    )


def pick_repair_chunks(
    C: int, K: int, S: int, R: int, W: int, A: int, budget_bytes: int
) -> int:
    """Spot-chunk count of the repair phase: 1 when the unchunked union
    fits ``budget_bytes``, else the smallest power of two (chunks at
    least MIN_REPAIR_CHUNK spots wide) that fits, else 0 (repair
    unavailable)."""
    n = 1
    while True:
        est = estimate_union_hbm_bytes(
            C, K, S, R, W, A, repair_spot_chunks=n
        )
        if est <= budget_bytes:
            return n
        n *= 2
        if -(-S // n) < MIN_REPAIR_CHUNK:
            return 0


def pick_carry_chunks(
    C: int, K: int, S: int, R: int, W: int, A: int, budget_bytes: int,
    carry_plane_bytes: Optional[int] = None,
) -> int:
    """Carry-chunk count of the carry-streamed union: 1 when it fits
    without streaming, else the smallest power of two (chunks at least
    MIN_CARRY_CHUNK spots wide) that fits, else 0."""
    n = 1
    while True:
        est = estimate_union_hbm_bytes(
            C, K, S, R, W, A,
            repair_spot_chunks=n,
            carry_chunks=n,
            carry_plane_bytes=carry_plane_bytes,
        )
        if est <= budget_bytes:
            return n
        n *= 2
        if -(-S // n) < MIN_CARRY_CHUNK:
            return 0


class TierDecision(NamedTuple):
    """The ladder's verdict at one problem's shapes. ``kind``: "single",
    "cand", "cand-chunked", "cand-carry" or "2d"; ``repair_chunks`` the
    repair phase's spot chunks (0 = no repair); ``carry_chunks`` > 0
    only on the carry tier; ``est_bytes`` the per-device estimate,
    ``carry_bytes`` its carries term; ``lane_block`` the lanes per
    device."""

    kind: str
    repair_chunks: int
    carry_chunks: int
    est_bytes: int
    carry_bytes: int
    lane_block: int
    repair_unavailable: bool


def pick_tier(
    C: int, K: int, S: int, R: int, W: int, A: int,
    *,
    n_devices: int,
    budget_bytes: Optional[int] = None,
    wants_repair: bool = True,
    carry_plane_bytes: Optional[int] = None,
    forced_carry_chunks: int = 0,
) -> TierDecision:
    """Walk the ladder: single device -> lane-sharded (repair intact) ->
    lane-sharded with spot-chunked repair -> lane-sharded carry-streamed
    narrow union -> 2-D (repair unavailable). ``forced_carry_chunks``
    pins the carry tier's chunk count (0 = ``pick_carry_chunks``);
    ``carry_plane_bytes`` may be a zero-argument callable, evaluated only
    on the carry rung."""
    budget = budget_bytes if budget_bytes else device_hbm_budget()
    own_chunks = 1 if wants_repair else 0

    def est(c, **kw):
        return estimate_union_hbm_bytes(c, K, S, R, W, A, **kw)

    def bd(c, **kw):
        return estimate_union_hbm_breakdown(c, K, S, R, W, A, **kw)

    full = est(C, repair_spot_chunks=own_chunks)
    if n_devices <= 1 or full <= budget:
        return TierDecision(
            "single", own_chunks, 0, full,
            bd(C, repair_spot_chunks=own_chunks)["carries"], C, False,
        )
    lane = -(-C // n_devices)
    lane_est = est(lane, repair_spot_chunks=own_chunks)
    if lane_est <= budget:
        return TierDecision(
            "cand", own_chunks, 0, lane_est,
            bd(lane, repair_spot_chunks=own_chunks)["carries"], lane, False,
        )
    chunks = (
        pick_repair_chunks(lane, K, S, R, W, A, budget)
        if wants_repair
        else 0
    )
    if chunks > 1:
        return TierDecision(
            "cand-chunked", chunks, 0,
            est(lane, repair_spot_chunks=chunks),
            bd(lane, repair_spot_chunks=chunks)["carries"], lane, False,
        )
    if wants_repair:
        cpb = (
            carry_plane_bytes()
            if callable(carry_plane_bytes)
            else carry_plane_bytes
        )
        cchunks = forced_carry_chunks or pick_carry_chunks(
            lane, K, S, R, W, A, budget, carry_plane_bytes=cpb,
        )
        if cchunks >= 1:
            kw = dict(
                repair_spot_chunks=cchunks,
                carry_chunks=cchunks,
                carry_plane_bytes=cpb,
            )
            return TierDecision(
                "cand-carry", cchunks, cchunks, est(lane, **kw),
                bd(lane, **kw)["carries"], lane, False,
            )
    return TierDecision(
        "2d", 0, 0, est(lane, repair_spot_chunks=0),
        bd(lane, repair_spot_chunks=0)["carries"], lane, wants_repair,
    )


def packed_shapes(packed) -> tuple:
    """(C, K, S, R, W, A) of a PackedCluster (numpy or torch)."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    W = packed.spot_taints.shape[1]
    A = packed.spot_aff.shape[1]
    return C, K, S, R, W, A


def device_hbm_budget(device=None) -> int:
    """The per-device byte budget: the card's total memory
    (``torch.cuda.mem_get_info``) for a CUDA ``device``, else
    DEFAULT_HBM_BYTES, times BUDGET_FRACTION."""
    total = 0
    if device is not None and torch.device(device).type == "cuda":
        _, total = torch.cuda.mem_get_info(torch.device(device))
    return int((total or DEFAULT_HBM_BYTES) * BUDGET_FRACTION)
