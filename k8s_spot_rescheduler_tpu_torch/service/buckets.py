"""Shape buckets: how unrelated tenants come to share one batched solve.

A copy of the JAX package's ``service/buckets.py``, bucket for bucket
and byte for byte. The service rounds every incoming problem UP to a
shape *bucket* — each of C (candidate lanes), K (pod slots) and S (spot
nodes) to the next power of two, floored at 8 — and pads the problem
into it:

- tenants in the same bucket stack along a leading tenant axis into ONE
  batched solve (``parallel/tenant_batch.py``): one launch of kernels
  B1t/B2t over a (lane block, tenant) grid;
- the distinct stacked shapes stay O(log C · log K · log S) for the
  fleet's lifetime (the JAX package's compile bound; here it bounds the
  launch geometries the kernels' occupancy cache holds).

Padding is semantics-free by the invariant the in-process high-water
padding relies on: padded candidate lanes have ``cand_valid=False``
(never feasible, never selected), padded pod slots have
``slot_valid=False`` (place nothing), and padded spot rows have
``spot_ok=False`` with zero capacity (fit nowhere). A tenant's selection
out of the padded problem is therefore identical to its unpadded solve.

Batch sizing is a device-memory question, answered by the estimator of
``solver/memory``: one tenant's union at the bucket shapes costs
``per_tenant_hbm_bytes``; the batch caps at ``budget // per-tenant``
tenants, the budget read from the card's memory when the caller names
a CUDA device.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster
from k8s_spot_rescheduler_tpu_torch.solver import memory

# Floors match the packer's _pad_dim minimum (multiples of 8 below the
# 128-lane width) so a tiny tenant's bucket is not pathologically small.
MIN_DIM = 8


def _pow2_at_least(n: int, floor: int = MIN_DIM) -> int:
    n = max(int(n), floor)
    return 1 << (n - 1).bit_length()


class Bucket(NamedTuple):
    """One shared-compile shape class. R/W/A are carried unrounded:
    they come from the config's resource axes and the constraint
    interning and are already tiny and stable."""

    C: int
    K: int
    S: int
    R: int
    W: int
    A: int

    @property
    def key(self) -> str:
        return f"C{self.C}xK{self.K}xS{self.S}xR{self.R}xW{self.W}xA{self.A}"


def bucket_for(packed: PackedCluster) -> Bucket:
    C, K, S, R, W, A = memory.packed_shapes(packed)
    return Bucket(
        C=_pow2_at_least(C), K=_pow2_at_least(K), S=_pow2_at_least(S),
        R=R, W=W, A=A,
    )


def _pad_leading(arr: np.ndarray, n: int) -> np.ndarray:
    """Pad axis 0 to length n with zeros (False for bool)."""
    if arr.shape[0] == n:
        return arr
    out = np.zeros((n,) + arr.shape[1:], arr.dtype)
    out[: arr.shape[0]] = arr
    return out


def pad_to_bucket(packed: PackedCluster, b: Bucket) -> PackedCluster:
    """Pad a problem into its bucket. Pads are inert by construction:
    invalid lanes, empty slots, not-ok zero-capacity spots."""
    C, K, S, R, W, A = memory.packed_shapes(packed)
    if (R, W, A) != (b.R, b.W, b.A):
        raise ValueError(
            f"packed (R={R}, W={W}, A={A}) does not belong to bucket {b.key}"
        )
    if C > b.C or K > b.K or S > b.S:
        raise ValueError(
            f"packed (C={C}, K={K}, S={S}) exceeds bucket {b.key}"
        )

    def pad_slots(arr):
        # [C, K, ...] -> [b.C, b.K, ...]: K pads first (middle axis),
        # then lanes
        if arr.shape[1] != b.K:
            out = np.zeros((arr.shape[0], b.K) + arr.shape[2:], arr.dtype)
            out[:, : arr.shape[1]] = arr
            arr = out
        return _pad_leading(arr, b.C)

    return PackedCluster(
        slot_req=pad_slots(packed.slot_req),
        slot_valid=pad_slots(packed.slot_valid),
        slot_tol=pad_slots(packed.slot_tol),
        slot_aff=pad_slots(packed.slot_aff),
        cand_valid=_pad_leading(packed.cand_valid, b.C),
        spot_free=_pad_leading(packed.spot_free, b.S),
        spot_count=_pad_leading(packed.spot_count, b.S),
        spot_max_pods=_pad_leading(packed.spot_max_pods, b.S),
        spot_taints=_pad_leading(packed.spot_taints, b.S),
        spot_ok=_pad_leading(packed.spot_ok, b.S),
        spot_aff=_pad_leading(packed.spot_aff, b.S),
    )


def stack_bucket(problems: List[PackedCluster], b: Bucket) -> PackedCluster:
    """Stack already-padded problems along a new leading tenant axis —
    the [T, ...] pytree parallel/tenant_batch.plan_tenants_batched
    consumes."""
    return PackedCluster(
        *(
            np.stack([getattr(p, f) for p in problems])
            for f in PackedCluster._fields
        )
    )


def per_tenant_hbm_bytes(
    b: Bucket, *, repair_spot_chunks: int = 1
) -> int:
    """One tenant's estimated solver footprint at the bucket shapes
    (solver/memory's union-program model — the batch dimension
    multiplies it linearly; lanes across tenants share nothing)."""
    return memory.estimate_union_hbm_bytes(
        b.C, b.K, b.S, b.R, b.W, b.A, repair_spot_chunks=repair_spot_chunks
    )


def max_batch_tenants(
    b: Bucket,
    *,
    budget_bytes: int = 0,
    repair_spot_chunks: int = 1,
    cap: int = 64,
    device=None,
) -> int:
    """How many tenants may share one batched solve at these shapes:
    ``budget // per-tenant estimate``, floored at 1 (a single tenant
    that alone exceeds the budget is the auto-shard tiers' problem, not
    the batcher's), capped to keep worst-case batch latency bounded.
    Without ``budget_bytes`` the budget is ``device``'s: the card's
    memory for a CUDA device, ``memory.DEFAULT_HBM_BYTES`` otherwise."""
    budget = budget_bytes or memory.device_hbm_budget(device)
    per = per_tenant_hbm_bytes(b, repair_spot_chunks=repair_spot_chunks)
    return max(1, min(int(cap), budget // max(per, 1)))
