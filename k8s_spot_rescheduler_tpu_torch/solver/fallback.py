"""The union solve: first-fit ∪ best-fit ∪ bounded repair.

The port of the JAX package's ``solver/fallback``: ``with_best_fit_
fallback``, ``with_repair``, the carry-streamed ``with_repair_streamed``
and ``union_program``, the one ladder every union is built from. A
lane's first-fit placement wins when first-fit proves it, then
best-fit's, then the repaired assignment; repair placements are
re-proven from scratch, so the union only ever adds drainable nodes.

Gating. The reference skips best-fit and repair under ``lax.cond`` when
the pass before left no valid lane unproven; the results are the same
either way, since a skipped pass would only be consumed on lanes with
``cand_valid`` False, where every pass reports infeasible and -1. Here:

- best-fit runs unconditionally: it is one kernel launch (B2, or B4 on
  the streamed union), cheaper than the host sync a gate would cost;
- repair is gated by ONE host sync per union solve (``bool(need)``):
  it is the expensive pass (plain PyTorch), and on a tick where the
  greedy passes prove every valid lane it is skipped.

So ``with_best_fit_fallback`` takes no sync and ``with_repair`` and
``with_repair_streamed`` one. Their solves keep the two stages as
attributes (``solve.greedy(packed)``, then ``solve.finish(packed,
union)``, which holds the sync), so a caller with several lane blocks
(``parallel/sharded_ffd``) launches every block's greedy passes before
any block syncs.
"""

from __future__ import annotations

import torch

from k8s_spot_rescheduler_tpu_torch.solver.carry import NARROW_LAYOUT
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult
from k8s_spot_rescheduler_tpu_torch.utils import tracing
from k8s_spot_rescheduler_tpu_torch.utils.syncs import device_sync


def _prefer(first: SolveResult, then: SolveResult) -> SolveResult:
    """``first``'s lanes where it proved them, else ``then``'s (lanes
    [C], or [T, C] of a tenant stack)."""
    return SolveResult(
        feasible=first.feasible | then.feasible,
        assignment=torch.where(
            first.feasible[..., None], first.assignment, then.assignment
        ),
    )


def _needs_repair(packed, greedy: SolveResult) -> bool:
    """The one host sync of a union solve: did the greedy passes leave a
    valid lane unproven?"""
    return device_sync(
        "repair-gate", bool, (packed.cand_valid & ~greedy.feasible).any()
    )


def _staged(greedy, finish):
    """``solve(packed) = finish(packed, greedy(packed))``, with both
    stages kept as attributes of ``solve``."""

    def solve(packed) -> SolveResult:
        return finish(packed, greedy(packed))

    solve.greedy = greedy
    solve.finish = finish
    return solve


def stages(solve):
    """(greedy, finish) of a union solve: its stages where it keeps
    them, else the whole solve and a ``finish`` that returns the union
    as it is."""
    return (
        getattr(solve, "greedy", solve),
        getattr(solve, "finish", lambda packed, union: union),
    )


def with_best_fit_fallback(solve_fn):
    """Union of ``solve_fn(packed)`` (first-fit) and
    ``solve_fn(packed, best_fit=True)``."""

    def solve(packed) -> SolveResult:
        with tracing.span("union.greedy"):
            return _prefer(solve_fn(packed), solve_fn(packed, best_fit=True))

    return solve


def with_repair(solve_fn, rounds: int, spot_chunks: int = 1):
    """First-fit ∪ best-fit ∪ ``rounds`` rounds of repair
    (``solver/repair.plan_repair``, or ``plan_repair_chunked`` over
    ``spot_chunks`` > 1 spot chunks, same results); repair runs only
    when the greedy passes left a valid lane unproven."""
    from k8s_spot_rescheduler_tpu_torch.solver.repair import (
        plan_repair,
        plan_repair_chunked,
    )

    greedy = with_best_fit_fallback(solve_fn)

    def repair(packed) -> SolveResult:
        if spot_chunks > 1:
            return plan_repair_chunked(
                packed, rounds=rounds, spot_chunks=spot_chunks
            )
        return plan_repair(packed, rounds=rounds)

    def finish(packed, union: SolveResult) -> SolveResult:
        if not _needs_repair(packed, union):
            return union
        with tracing.span("union.repair"):
            return _prefer(union, repair(packed))

    return _staged(greedy, finish)


def with_repair_streamed(
    rounds: int,
    carry_chunks: int,
    layout,
    chain: bool = True,
    best_fit_fallback: bool = True,
    use_kernel: bool = False,
):
    """The carry-streamed union: first-fit with the spot axis streamed
    in ``carry_chunks`` ordered chunks, best-fit as the per-slot
    elect-then-commit over the narrow delta state, and the spot-chunked
    repair rounds, every pass on the delta carry ``layout``
    (``solver/carry``). Same results as ``with_repair(plan_ffd,
    rounds)``.

    ``use_kernel`` (the JAX package's ``use_pallas``) runs the greedy
    passes as kernels: best-fit as B4 (``ops/ffd_kernels.plan_stream_bf_
    kernel``) and first-fit as B1 for one chunk or B3 over the
    ``carry_chunks`` spot chunks (``plan_stream_ff_kernel``); on CPU
    tensors those wrappers take their plain versions, the passes below.
    Without it both greedy passes are the plain ``plan_ffd_streamed``.
    Repair is plain PyTorch either way."""
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd_streamed
    from k8s_spot_rescheduler_tpu_torch.solver.repair import (
        plan_repair_chunked,
    )

    if use_kernel:
        from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
            plan_stream_bf_kernel,
            plan_stream_ff_kernel,
        )

        def first_fit(packed):
            return plan_stream_ff_kernel(
                packed, carry_chunks=carry_chunks, layout=layout
            )

        def best_fit(packed):
            return plan_stream_bf_kernel(
                packed, carry_chunks=carry_chunks, layout=layout
            )
    else:
        def first_fit(packed):
            return plan_ffd_streamed(
                packed, carry_chunks=carry_chunks, layout=layout
            )

        def best_fit(packed):
            return plan_ffd_streamed(
                packed, carry_chunks=carry_chunks, layout=layout,
                best_fit=True,
            )

    def greedy(packed) -> SolveResult:
        with tracing.span("union.greedy"):
            ff = first_fit(packed)
            if not best_fit_fallback:
                return ff
            return _prefer(ff, best_fit(packed))

    def finish(packed, union: SolveResult) -> SolveResult:
        if (not best_fit_fallback or rounds <= 0
                or not _needs_repair(packed, union)):
            return union
        with tracing.span("union.repair"):
            return _prefer(
                union,
                plan_repair_chunked(
                    packed,
                    rounds=rounds,
                    chain=chain,
                    spot_chunks=carry_chunks,
                    layout=layout,
                ),
            )

    return _staged(greedy, finish)


def union_program(
    rounds: int,
    best_fit_fallback: bool = True,
    *,
    repair_spot_chunks: int = 1,
    carry_chunks: int = 0,
    carry_layout=None,
    use_kernel: bool = False,
):
    """The union-composition ladder: ``carry_chunks`` >= 1 selects the
    carry-streamed narrow union (``carry_layout`` defaults to
    NARROW_LAYOUT); otherwise first-fit ∪ best-fit ∪ (spot-chunked)
    repair per the flags. ``use_kernel`` runs the greedy passes as the
    kernels (``ops/ffd_kernels``), else as the plain ``plan_ffd``."""
    if carry_chunks and carry_chunks >= 1:
        return with_repair_streamed(
            rounds,
            carry_chunks,
            carry_layout if carry_layout is not None else NARROW_LAYOUT,
            best_fit_fallback=best_fit_fallback,
            use_kernel=use_kernel,
        )
    if use_kernel:
        from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
            greedy_solver,
        )

        solve_fn = greedy_solver()
    else:
        from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd

        solve_fn = plan_ffd
    if best_fit_fallback and rounds > 0:
        return with_repair(solve_fn, rounds, spot_chunks=repair_spot_chunks)
    if best_fit_fallback:
        return with_best_fit_fallback(solve_fn)
    return solve_fn
