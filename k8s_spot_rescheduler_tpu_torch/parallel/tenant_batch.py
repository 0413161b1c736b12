"""Multi-tenant batched selection: a fleet of clusters in one solve.

The port of the JAX package's ``parallel/tenant_batch.py``. Tenants
(whole clusters) share nothing: not lanes, not a spot pool. So a
fleet's concurrent plan requests, padded to one shape bucket
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
  selection_vector`` gives for tenant t alone, bit for bit. With
  ``carry_chunks`` >= 1 (the carry tier) every tenant runs the
  carry-streamed narrow union instead, tenant by tenant (B3 and B4 a
  tenant on the card), with the same rows;
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

The tenant mesh (``parallel/mesh.make_tenant_mesh``): with a mesh of n
devices and T a multiple of n, each device holds a contiguous block of
T/n tenants and runs the batch on it (one B1t and one B2t launch a
block, ``gridDim.y`` the block's tenant count); every block's greedy
passes are launched before any block's repair sync, and the rows are
gathered on the mesh's first device. With no mesh, one device, or a T
the mesh does not divide, the stack solves where it lies, as the JAX
package falls back to a plain ``vmap``; the service pads T to a
multiple with inert all-zero tenants. The ``make_*`` factories return
the programs the service calls; PyTorch runs eagerly, so they are
partial applications, not compiles.
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


def _blocks(mesh, stacked):
    """The stack's tenant blocks, each a PackedCluster on its device:
    one block a device of ``mesh`` when T divides among them, else the
    whole stack where it lies (on the device, numpy uploaded to none)."""
    from k8s_spot_rescheduler_tpu_torch.parallel.mesh import (
        DeviceMesh,
        place,
    )

    if mesh is not None and not isinstance(mesh, DeviceMesh):
        raise ValueError(f"not a tenant mesh: {mesh!r}")
    T = stacked.slot_req.shape[0]
    if T < 1:
        raise ValueError("a batch needs at least one tenant")
    n = mesh.devices.size if mesh is not None else 1
    if n <= 1 or T % n != 0:
        return [stacked]
    Tb = T // n
    return [place(stacked, dev, tenants=slice(i * Tb, (i + 1) * Tb))
            for i, dev in enumerate(mesh.devices.flat)]


def _gather(parts, mesh) -> torch.Tensor:
    """The blocks' outputs stacked on the mesh's first device."""
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p.to(mesh.lead) for p in parts])


def _tenant_stages(rounds: int, best_fit_fallback: bool,
                   carry_chunks: int = 0, carry_layout=None):
    """(greedy, finish) of the stack's union (``solver/fallback.stages``
    shape): greedy is B1t then B2t on the stack, finish the repair of
    the tenants greedy left a valid lane unproven. With
    ``carry_chunks`` >= 1 each tenant's carry-streamed union, in the
    same two stages, tenant by tenant."""
    from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
        plan_ffd_tenants_kernel,
        plan_repair_kernel,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        _prefer,
        stages,
        union_program,
    )

    if carry_chunks and carry_chunks >= 1:
        one_greedy, one_finish = stages(union_program(
            rounds, best_fit_fallback, carry_chunks=carry_chunks,
            carry_layout=carry_layout, use_kernel=True,
        ))

        def greedy(stacked):
            return [one_greedy(tenant_slice(stacked, t))
                    for t in range(stacked.slot_req.shape[0])]

        def finish(stacked, unions):
            done = [one_finish(tenant_slice(stacked, t), u)
                    for t, u in enumerate(unions)]
            return SolveResult(
                torch.stack([r.feasible for r in done]),
                torch.stack([r.assignment for r in done]),
            )

        return greedy, finish

    def greedy(stacked):
        union = plan_ffd_tenants_kernel(stacked)
        if not best_fit_fallback:
            return union
        return _prefer(union, plan_ffd_tenants_kernel(stacked, best_fit=True))

    def finish(stacked, union):
        if not best_fit_fallback or rounds <= 0:
            return union
        # the one host sync of the stack: which tenants need repair
        need = (stacked.cand_valid & ~union.feasible).any(dim=1).cpu()
        tenants = need.nonzero().flatten().tolist()
        if not tenants:
            return union
        feasible = union.feasible.clone()
        assignment = union.assignment.clone()
        for t in tenants:
            one = tenant_slice(stacked, t)
            unproven = (one.cand_valid & ~union.feasible[t]).contiguous()
            merged = _prefer(
                SolveResult(union.feasible[t], union.assignment[t]),
                plan_repair_kernel(one, unproven, rounds),
            )
            feasible[t] = merged.feasible
            assignment[t] = merged.assignment
        return SolveResult(feasible, assignment)

    return greedy, finish


def tenant_union(stacked, *, rounds: int = 0,
                 best_fit_fallback: bool = True) -> SolveResult:
    """The union of ``solver/fallback.union_program(rounds,
    best_fit_fallback)`` on every tenant of a stacked pack: feasible
    [T, C], assignment [T, C, K]. First-fit and best-fit are one B1t and
    one B2t launch over the stack (their plain versions on CPU tensors);
    repair runs per tenant, only where greedy left a valid lane
    unproven: one B5 launch over its unproven lanes on the card
    (``ops/ffd_kernels.plan_repair_kernel``)."""
    greedy, finish = _tenant_stages(rounds, best_fit_fallback)
    return finish(stacked, greedy(stacked))


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
    carry_chunks: int = 0,
    carry_layout=None,
) -> torch.Tensor:
    """Solve T stacked tenant problems; returns int32 [T, 3 + K] on the
    stack's device (the mesh's first device over a tenant ``mesh``).
    Row t decodes with ``solver/select.decode_selection`` exactly as a
    solo solve would. ``carry_chunks`` >= 1 runs every tenant on the
    carry-streamed narrow union under ``carry_layout`` (NARROW_LAYOUT
    when None)."""
    greedy, finish = _tenant_stages(rounds, best_fit_fallback, carry_chunks,
                                    carry_layout)
    blocks = _blocks(mesh, stacked)
    unions = [greedy(b) for b in blocks]  # every block launched first
    return _gather([selection_rows(finish(b, u))
                    for b, u in zip(blocks, unions)], mesh)


def plan_tenants_scheduled(
    mesh,
    stacked: PackedCluster,
    *,
    horizon: int,
    rounds: int = 0,
    best_fit_fallback: bool = True,
) -> torch.Tensor:
    """Solve T stacked tenant problems to whole drain schedules; returns
    int32 [T, horizon, 3 + K]. Tenant by tenant (each block's on its
    device over a tenant ``mesh``), each the drain-to-exhaustion loop
    of ``solver/schedule.schedule_matrix`` over the union with the
    kernels on; a tenant's rows after its terminal probe stay -1, as
    under the JAX package's ``vmap``."""
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.schedule import schedule_matrix

    solve = union_program(rounds, best_fit_fallback, use_kernel=True)
    return _gather([
        torch.stack([
            schedule_matrix(solve, tenant_slice(block, t), horizon)
            for t in range(block.slot_req.shape[0])
        ])
        for block in _blocks(mesh, stacked)
    ], mesh)


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
    carry_chunks: int = 0,
    carry_layout=None,
):
    """The service's batch program: ``plan_tenants_batched`` with the
    union's flags bound; one callable for every bucket. ``carry_chunks``
    >= 1 runs every tenant on the carry-streamed narrow union (same
    selections, narrower carries)."""
    return functools.partial(
        plan_tenants_batched, mesh, rounds=rounds,
        best_fit_fallback=best_fit_fallback,
        carry_chunks=carry_chunks, carry_layout=carry_layout,
    )
