"""The union solve: first-fit ∪ best-fit ∪ bounded repair.

The port of the JAX package's ``solver/fallback.with_best_fit_fallback``
and ``with_repair``. A lane's first-fit placement wins when first-fit
proves it, then best-fit's, then the repaired assignment; repair
placements are re-proven from scratch, so the union only ever adds
drainable nodes.

Gating. The reference skips best-fit and repair under ``lax.cond`` when
the pass before left no valid lane unproven; the results are the same
either way, since a skipped pass would only be consumed on lanes with
``cand_valid`` False, where every pass reports infeasible and -1. Here:

- best-fit runs unconditionally: it is one kernel launch (B2), cheaper
  than the host sync a gate would cost;
- repair is gated by ONE host sync per union solve (``bool(need)``):
  it is the expensive pass (plain PyTorch), and on a tick where the
  greedy passes prove every valid lane it is skipped.

So ``with_best_fit_fallback`` takes no sync and ``with_repair`` one.
"""

from __future__ import annotations

import torch

from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult


def _prefer(first: SolveResult, then: SolveResult) -> SolveResult:
    """``first``'s lanes where it proved them, else ``then``'s."""
    return SolveResult(
        feasible=first.feasible | then.feasible,
        assignment=torch.where(
            first.feasible[:, None], first.assignment, then.assignment
        ),
    )


def with_best_fit_fallback(solve_fn):
    """Union of ``solve_fn(packed)`` (first-fit) and
    ``solve_fn(packed, best_fit=True)``."""

    def solve(packed) -> SolveResult:
        return _prefer(solve_fn(packed), solve_fn(packed, best_fit=True))

    return solve


def with_repair(solve_fn, rounds: int):
    """First-fit ∪ best-fit ∪ ``rounds`` rounds of repair
    (``solver/repair.plan_repair``); repair runs only when the greedy
    passes left a valid lane unproven."""
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair

    greedy = with_best_fit_fallback(solve_fn)

    def solve(packed) -> SolveResult:
        union = greedy(packed)
        if not bool((packed.cand_valid & ~union.feasible).any()):
            return union
        return _prefer(union, plan_repair(packed, rounds=rounds))

    return solve
