"""Multi-tenant batched selection: a fleet of clusters in one solve.

The port of the JAX package's ``parallel/tenant_batch.py`` on one
device. Tenants (whole clusters) share nothing: not lanes, not a spot
pool. So a fleet's concurrent plan requests, padded to one shape bucket
(``service/buckets.py``), stack along a leading tenant axis and solve
together:

- ``plan_tenants_batched``: the union of ``solver/fallback.
  union_program`` over the stack, first-fit as ONE launch of kernel B1t
  and best-fit as ONE launch of B2t (``ops/ffd_kernels.
  plan_ffd_tenants_kernel``: B1/B2 over a (lane block, tenant) grid);
  then repair and its validation per tenant, only for tenants whose
  greedy passes left a valid lane unproven (one host sync for the
  stack, as the single-problem union gates its repair), and the
  selection of every tenant into one int32 ``[T, 3+K]`` tensor, which
  the caller fetches once. Row t is what ``solver/select.
  selection_vector`` gives for tenant t alone, bit for bit;
- ``plan_tenants_scheduled``: whole drain schedules ``[T, horizon,
  3+K]``. The JAX package ``vmap``s the drain-to-exhaustion loop, which
  then runs until the last tenant ends with the finished tenants' rows
  left at -1; here the loop runs tenant by tenant
  (``solver/schedule.schedule_matrix`` over the kernels' union), which
  leaves the same rows;
- ``apply_tenant_deltas``: T tenants' padded wire deltas scattered into
  their stacked states, one ``index_copy_`` per field with the tenant
  axis folded into the row axis. The JAX program drops the index pads
  (one past the axis end) by ``mode="drop"``; torch's ``index_copy_``
  raises on them, so pads are trimmed first and never reach it.

The ``mesh`` argument is kept for the JAX package's signatures and
takes only ``None``: the tenant mesh (one tenant block per device) is
not ported, nor is the JAX batch's carry-streamed tier
(``carry_chunks``), which the service never asks for. The ``make_*``
factories return the programs the service calls; PyTorch runs eagerly,
so they are partial applications, not compiles.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.models.delta import DELTA_FIELDS
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    host_array,
    tenant_slice,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import first_true
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult


def _one_device(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            "the tenant mesh is not ported: the batch runs on one device "
            "(mesh=None)"
        )


def tenant_union(stacked, *, rounds: int = 0,
                 best_fit_fallback: bool = True) -> SolveResult:
    """The union of ``solver/fallback.union_program(rounds,
    best_fit_fallback)`` on every tenant of a stacked pack: feasible
    [T, C], assignment [T, C, K]. First-fit and best-fit are one B1t and
    one B2t launch over the stack (their plain versions on CPU tensors);
    repair runs per tenant, only where greedy left a valid lane
    unproven."""
    from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
        plan_ffd_tenants_kernel,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import _prefer
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair

    union = plan_ffd_tenants_kernel(stacked)
    if not best_fit_fallback:
        return union
    union = _prefer(union, plan_ffd_tenants_kernel(stacked, best_fit=True))
    if rounds <= 0:
        return union
    # the one host sync of the stack: which tenants need repair
    need = (stacked.cand_valid & ~union.feasible).any(dim=1).cpu()
    tenants = need.nonzero().flatten().tolist()
    if not tenants:
        return union
    feasible = union.feasible.clone()
    assignment = union.assignment.clone()
    for t in tenants:
        merged = _prefer(
            SolveResult(union.feasible[t], union.assignment[t]),
            plan_repair(tenant_slice(stacked, t), rounds=rounds),
        )
        feasible[t] = merged.feasible
        assignment[t] = merged.assignment
    return SolveResult(feasible, assignment)


def selection_rows(res: SolveResult) -> torch.Tensor:
    """int32 [T, 3 + K]: each tenant's ``[idx, found, n_feasible,
    row...]``, as ``solver/select.selection_vector`` computes it alone
    (the first feasible lane in drain-priority order)."""
    feasible = res.feasible
    idx = first_true(feasible, dim=1)
    rows = res.assignment[torch.arange(feasible.shape[0]), idx]
    return torch.cat(
        [
            idx[:, None].to(torch.int32),
            feasible.any(dim=1)[:, None].to(torch.int32),
            feasible.sum(dim=1)[:, None].to(torch.int32),
            rows.to(torch.int32),
        ],
        dim=1,
    )


def plan_tenants_batched(
    mesh,
    stacked: PackedCluster,
    *,
    rounds: int = 0,
    best_fit_fallback: bool = True,
) -> torch.Tensor:
    """Solve T stacked tenant problems; returns int32 [T, 3 + K] on the
    stack's device. Row t decodes with ``solver/select.decode_selection``
    exactly as a solo solve would."""
    _one_device(mesh)
    if stacked.slot_req.shape[0] < 1:
        raise ValueError("a batch needs at least one tenant")
    return selection_rows(tenant_union(
        stacked, rounds=rounds, best_fit_fallback=best_fit_fallback
    ))


def plan_tenants_scheduled(
    mesh,
    stacked: PackedCluster,
    *,
    horizon: int,
    rounds: int = 0,
    best_fit_fallback: bool = True,
) -> torch.Tensor:
    """Solve T stacked tenant problems to whole drain schedules; returns
    int32 [T, horizon, 3 + K]. Tenant by tenant, each the
    drain-to-exhaustion loop of ``solver/schedule.schedule_matrix`` over
    the union with the kernels on; a tenant's rows after its terminal
    probe stay -1, as under the JAX package's ``vmap``."""
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.schedule import schedule_matrix

    _one_device(mesh)
    solve = union_program(rounds, best_fit_fallback, use_kernel=True)
    return torch.stack([
        schedule_matrix(solve, tenant_slice(stacked, t), horizon)
        for t in range(stacked.slot_req.shape[0])
    ])


def make_tenant_schedule_planner(
    mesh=None,
    *,
    horizon: int,
    rounds: int = 0,
    best_fit_fallback: bool = True,
):
    """The service's batched-schedule program at one horizon."""
    return functools.partial(
        plan_tenants_scheduled, mesh, horizon=horizon, rounds=rounds,
        best_fit_fallback=best_fit_fallback,
    )


def apply_tenant_deltas(
    slot_req, slot_valid, slot_tol, slot_aff, cand_valid,
    spot_free, spot_count, spot_max_pods, spot_taints, spot_ok, spot_aff,
    deltas,
) -> PackedCluster:
    """Scatter T tenants' wire deltas into their stacked states, IN
    PLACE, and return the states as a PackedCluster. Every state tensor
    carries a leading tenant axis ([T, C, ...] on one device, word
    fields as int32 bits); ``deltas`` is a ``PackedDelta`` of numpy
    arrays with a leading tenant axis, each tenant's sections padded to
    one length by ``models/delta.pad_packed_delta`` with index pads one
    past the axis end. Pads are trimmed on the host and never reach
    ``index_copy_``; a full-pack tenant rides along with an all-pad
    empty delta. One host-to-device copy and one ``index_copy_`` per
    field: the tenant axis folds into the row axis."""
    states = PackedCluster(
        slot_req, slot_valid, slot_tol, slot_aff, cand_valid,
        spot_free, spot_count, spot_max_pods, spot_taints, spot_ok, spot_aff,
    )
    for field, idx_name, data_name in DELTA_FIELDS:
        state = getattr(states, field)
        T, n = state.shape[:2]
        idx = np.asarray(getattr(deltas, idx_name)).astype(np.int64)
        keep = (idx >= 0) & (idx < n)  # index pads point one past the end
        if not keep.any():
            continue
        rows = (idx + n * np.arange(T)[:, None])[keep]
        vals = host_array(field, np.asarray(getattr(deltas, data_name))[keep])
        state.view((T * n,) + tuple(state.shape[2:])).index_copy_(
            0,
            torch.from_numpy(rows).to(state.device),
            torch.from_numpy(vals).to(state.device),
        )
    return states


def make_tenant_delta_applier():
    """The service's batched delta scatter (``apply_tenant_deltas``)."""
    return apply_tenant_deltas


def make_tenant_batch_planner(
    mesh=None,
    *,
    rounds: int = 0,
    best_fit_fallback: bool = True,
):
    """The service's batch program: ``plan_tenants_batched`` with the
    union's flags bound; one callable for every bucket."""
    return functools.partial(
        plan_tenants_batched, mesh, rounds=rounds,
        best_fit_fallback=best_fit_fallback,
    )
