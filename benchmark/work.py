"""The yardstick of the greedy kernels: bytes and operations a pass
needs, and the card's published peaks.

``ffd_work`` and ``work_bound`` are frozen copies of ``chip_smoke.py``'s
functions of the same names at commit
ff5fa8423fbb72910a77038441847ae0cfea3599 (with numpy imported here
instead of passed in). Peaks: NVIDIA's H100 SXM data sheet, 3.35 TB/s of
HBM3 and 67 TFLOP/s of float32 outside the tensor cores, at the full
700 W power limit.
"""

from __future__ import annotations

import numpy as np

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12


def work_bound(nbytes: int, ops: int):
    """(bound_ms, bound_by) of ``nbytes`` moved and ``ops`` f32
    operations on the card."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ffd_work(packed, raw_chosen, best_fit: bool):
    """(bytes, operations) one greedy pass on ``packed`` needs, counting
    what this data needs. Only the spots up to the last usable one
    count (``spot_ok``): past it no pod can fit, and a bucket's pad
    spots (not ok, at the end) are no work the tenant needs. Bytes: the
    request, toleration and affinity rows of live slots (valid slots of
    valid lanes; the kernel skips the rest), the validity bits of valid
    lanes, ``cand_valid`` and those spots' arrays once, feasible +
    assignment written once. Operations: each tested (pod, spot) pair
    costs R + W + A + 3 (+2 for best-fit's slack compare); first-fit
    needs the spots up to the first fit (all of them when none fits),
    best-fit all of them."""
    C, K, R = packed.slot_req.shape
    ok = np.flatnonzero(np.asarray(packed.spot_ok))
    S = int(ok[-1]) + 1 if ok.size else 0
    W = packed.spot_taints.shape[1]
    A = packed.spot_aff.shape[1]
    cand = np.asarray(packed.cand_valid)
    live = np.asarray(packed.slot_valid) & cand[:, None]
    spot_bytes = sum(
        np.asarray(getattr(packed, f))[:S].nbytes
        for f in packed._fields if f.startswith("spot_")
    )
    nbytes = (
        int(live.sum()) * 4 * (R + W + A)  # f32 requests, int32 words
        + int(cand.sum()) * K + C + spot_bytes  # validity bits, spots
        + C + C * K * 4  # feasible, assignment
    )
    if best_fit:
        tested = int(live.sum()) * S
        per = R + W + A + 5
    else:
        chosen = np.asarray(raw_chosen)
        tested = int(np.where(chosen >= 0, chosen + 1, S)[live].sum())
        per = R + W + A + 3
    return nbytes, tested * per


def b2_bound_s(packed, launches) -> float:
    """Seconds the best-fit passes of ``launches`` need at the card's
    peaks: one launch a step of a cut, each the list of the lanes
    drained before it (retired from the pass)."""
    total = 0.0
    for drained in launches:
        p = packed
        if drained:
            cand = np.array(p.cand_valid)
            cand[list(drained)] = False
            p = p._replace(cand_valid=cand)
        total += work_bound(*ffd_work(p, None, True))[0] / 1e3
    return total
