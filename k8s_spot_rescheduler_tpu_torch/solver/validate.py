"""From-scratch assignment validation, the repair phase's safety net.

The port of the JAX package's ``solver/validate.validate_assignment``,
torch only. Every lane's final assignment is re-proven against the
ORIGINAL packed state, so a search bug can lose a drain but never
approve one that strands a pod.

Exactness: the per-node load is summed with ``index_add_`` over the
placed slots, never through a matmul that TF32 could take. Every
request is an integral f32 below 2**24, so the sum is exact in any
order (atomics on the card included).
"""

from __future__ import annotations

import torch


def validate_assignment(packed, assign) -> torch.Tensor:
    """bool [C]: lane c's assignment row is a complete, predicate-valid
    placement of all its valid slots onto the spot pool. ``assign`` is
    int [C, K], -1 = unplaced. Checked against the un-depleted spot
    state: completeness, bounds, capacity, pod count, static admission
    words and readiness, and anti-affinity (pairwise and against each
    node's resident bits)."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    dev = packed.slot_req.device
    valid = packed.slot_valid
    placed = assign >= 0

    complete = (placed == valid).all(dim=-1)  # [C]
    in_bounds = torch.where(placed, assign < S, True).all(dim=-1)

    s_idx = assign.clamp(0, S - 1).long()  # [C, K]
    live = placed & valid
    # per-(lane, node) load and pod count: [C * S] rows indexed c*S + s
    flat = (torch.arange(C, device=dev)[:, None] * S + s_idx).reshape(-1)
    load = torch.zeros((C * S, R), dtype=packed.slot_req.dtype, device=dev)
    load.index_add_(
        0, flat, (packed.slot_req * live[..., None]).reshape(C * K, R)
    )
    n_on = torch.zeros(C * S, dtype=torch.int32, device=dev)
    n_on.index_add_(0, flat, live.reshape(-1).to(torch.int32))
    load = load.view(C, S, R)
    n_on = n_on.view(C, S)
    # capacity binds only nodes that received placements: an untouched
    # node may carry negative free (over-committed in the observed
    # cluster); placing on one is what is forbidden
    used = n_on > 0
    res_ok = (
        (packed.spot_free[None] - load >= 0) | ~used[..., None]
    ).flatten(1).all(dim=-1)  # [C]
    cnt_ok = (
        (packed.spot_count[None] + n_on <= packed.spot_max_pods[None])
        | ~used
    ).all(dim=-1)

    # per-placement static admission word check
    node_words = packed.spot_taints[s_idx]  # [C, K, W]
    word_ok = ((node_words & ~packed.slot_tol) == 0).all(dim=-1)  # [C, K]
    ok_lane = packed.spot_ok[s_idx]  # [C, K]
    static_ok = torch.where(live, word_ok & ok_lane, True).all(dim=-1)

    # anti-affinity: pairwise within a node + against the node's own bits
    aff = packed.slot_aff  # [C, K, A]
    share = ((aff[:, :, None, :] & aff[:, None, :, :]) != 0).any(dim=-1)
    same = (s_idx[:, :, None] == s_idx[:, None, :]) & (
        live[:, :, None] & live[:, None, :]
    )
    off_diag = ~torch.eye(K, dtype=torch.bool, device=dev)[None]
    pair_ok = ~(share & same & off_diag).flatten(1).any(dim=-1)
    node0 = packed.spot_aff[s_idx]  # [C, K, A]
    share0 = ((aff & node0) != 0).any(dim=-1)  # [C, K]
    node_aff_ok = ~(share0 & live).any(dim=-1)

    return (
        packed.cand_valid
        & complete
        & in_bounds
        & res_ok
        & cnt_ok
        & static_ok
        & pair_ok
        & node_aff_ok
    )

