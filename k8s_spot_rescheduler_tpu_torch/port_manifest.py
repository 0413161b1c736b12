"""PORT_MANIFEST: where each of the JAX package's hot programs lives in
the port.

The JAX package declares its traced hot programs in ``HOT_PROGRAMS``
dicts, merged by its ``hot_programs.collect()`` over the modules of
``hot_programs.MANIFEST_MODULES``: 24 names such as ``ffd.first_fit``
or ``service.tenant_batch``. This table maps every one of those names to
the qualified name (``module:attribute``) of the port's twin, a tuple of
them where the program became more than one function, or to
``PENDING`` where the port has no twin yet; no name is pending now.
``tests/test_torch_manifest.py`` holds it against ``collect()``: every
name is a key, every twin resolves by ``importlib``, and the pending
set is the one stated there.

Plain data: importing this module imports nothing else of the port.
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

PENDING = "pending"

_P = "k8s_spot_rescheduler_tpu_torch."

PORT_MANIFEST: Dict[str, Union[str, Tuple[str, ...]]] = {
    # greedy passes (the plain versions; on the card B1/B2 and B3/B4)
    "ffd.first_fit": _P + "solver.ffd:plan_ffd",
    "ffd.best_fit": _P + "solver.ffd:plan_ffd",
    "ffd.streamed": _P + "solver.ffd:plan_ffd_streamed",
    "ffd.streamed_best_fit": _P + "solver.ffd:plan_ffd_streamed",
    # repair
    "repair.rounds": _P + "solver.repair:plan_repair",
    "repair.chunked": _P + "solver.repair:plan_repair_chunked",
    # selection
    "select.fused_union": _P + "solver.select:make_fused_planner",
    "select.staged_chunk": _P + "solver.select:StagedPlanner._dispatch_next",
    "prefilter.lane_bound": _P + "solver.prefilter:lane_maybe_feasible",
    # the unions
    "union.greedy": _P + "solver.fallback:with_best_fit_fallback",
    "union.repair": _P + "solver.fallback:with_repair",
    "union.repair_chunked": _P + "solver.fallback:with_repair",
    "union.repair_streamed": _P + "solver.fallback:with_repair_streamed",
    "schedule.drain_to_exhaustion": _P + "solver.schedule:make_schedule_planner",
    # the Pallas kernel: B1/B2 and B3 (first-fit over spot chunks), B4
    "pallas.first_fit": (
        _P + "ops.ffd_kernels:plan_ffd_kernel",
        _P + "ops.ffd_kernels:plan_ffd_chunked",
    ),
    "pallas.stream_best_fit": _P + "ops.ffd_kernels:plan_stream_bf_kernel",
    # multiple devices: the 2-D tier and the cand tier's block programs
    "sharded.ffd_2d": _P + "parallel.sharded_ffd:plan_ffd_sharded",
    "sharded.union_cand": _P + "parallel.sharded_ffd:plan_union_cand_sharded",
    "sharded.union_cand_carry": (
        _P + "parallel.sharded_ffd:plan_union_cand_sharded",
        _P + "solver.fallback:with_repair_streamed",
    ),
    # the planner service's tenant batch and its carry tier
    "service.tenant_batch": _P + "parallel.tenant_batch:plan_tenants_batched",
    "service.tenant_batch_carry": (
        _P + "parallel.tenant_batch:plan_tenants_batched",
        _P + "solver.fallback:with_repair_streamed",
    ),
    "service.tenant_delta_scatter": _P + "parallel.tenant_batch:apply_tenant_deltas",
    "service.tenant_schedule": _P + "parallel.tenant_batch:plan_tenants_scheduled",
    # the resident cache's delta write
    "planner.delta_scatter": _P + "planner.solver_planner:TorchSolverPlanner._apply_delta",
}


def twins(name: str) -> Tuple[str, ...]:
    """The qualified names ``name`` maps to (empty when pending)."""
    value = PORT_MANIFEST[name]
    if value == PENDING:
        return ()
    return (value,) if isinstance(value, str) else tuple(value)


def pending() -> frozenset:
    """The reference names the port has no twin for yet."""
    return frozenset(k for k, v in PORT_MANIFEST.items() if v == PENDING)

