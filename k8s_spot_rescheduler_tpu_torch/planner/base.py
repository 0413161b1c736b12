"""The Planner interface.

BASELINE.json's north star puts the solver "behind a Planner interface so
the eviction/drain path stays unchanged": the control loop hands the
classified node map + PDBs to ``plan`` and gets back either a drain
decision or None — it never sees tensors, meshes or devices.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Sequence

from k8s_spot_rescheduler_tpu_torch.models.cluster import NodeInfo, NodeMap, PDBSpec, PodSpec


@dataclasses.dataclass
class DrainPlan:
    """A proven-feasible drain of one on-demand node.

    ``assignments`` maps pod uid -> spot node name: the placement the
    feasibility proof found. The reference discards this (the live
    kube-scheduler re-places evicted pods, README.md:116-123); we surface it
    for observability and the quality benchmarks.
    """

    node: NodeInfo
    pods: List[PodSpec]
    assignments: Dict[str, str]
    candidate_index: int


@dataclasses.dataclass
class PlanReport:
    """Telemetry of one solve, for metrics and the loop's logging."""

    plan: Optional[DrainPlan]
    n_candidates: int
    n_feasible: int
    solve_seconds: float
    solver: str = ""
    # all feasible candidates in drain-priority order (multi-drain planning
    # and the quality benchmarks read this; the faithful loop uses plan only)
    feasible_candidates: List[DrainPlan] = dataclasses.field(default_factory=list)
    # --- incremental device-resident tick telemetry (solver planner;
    # loop/controller.py mirrors these into metrics/registry.py) ---
    # changed lanes the delta-pack applied; -1 = device cache not in play
    delta_pack_lanes: int = -1
    # this tick re-uploaded the whole problem (cold cache / shape growth)
    full_repack: bool = False
    # host→device bytes this tick actually shipped; -1 = unknown (the
    # non-incremental device path uploads inside jit, untracked)
    upload_bytes: int = -1
    # staged-solve coverage; -1 chunks_solved = unstaged full solve
    chunks_solved: int = -1
    chunks_skipped: int = 0
    # early exit truncated n_feasible to the solved prefix (a drain WAS
    # found; the why-no-drain gauges read this tick as an upper bound)
    count_truncated: bool = False
    # spot chunks the repair phase ran with: 1 = unchunked, >1 = the
    # elect-then-commit spot-chunked search engaged (per-lane repair
    # state exceeded one device), 0 = repair off/unavailable this solve
    repair_chunks: int = 1
    # carry chunks of the carry-streamed narrow tier (solver/carry.py +
    # solver/fallback.with_repair_streamed): 0 = a wide-carry tier ran
    carry_chunks: int = 0
    # --- drain-schedule telemetry (planner/schedule.py) ---
    # steps in the schedule this plan was served from; 0 = per-tick plan
    schedule_len: int = 0
    # which schedule step this report executed; -1 = not a schedule step
    schedule_step: int = -1


class Planner(Protocol):
    def plan(self, node_map: NodeMap, pdbs: Sequence[PDBSpec]) -> PlanReport: ...


def pack_observation(planner, observation, pdbs: Sequence[PDBSpec]):
    """Observation -> (packed, meta) through the production pack path
    with ``planner``'s high-water pads — THE one implementation behind
    ``SolverPlanner._pack_observation`` and
    ``RemotePlanner._pack_observation`` (and therefore behind every
    drain-schedule step's live re-pack), so the local and wire pack
    paths cannot drift. ``planner`` carries ``config``, the
    ``_pad_c/_pad_k/_pad_s`` high-water marks (grown in place: shapes
    only ever grow, so neither jit compiles nor service-side buckets
    churn), and ``last_packed`` (the offline analyzers' tap)."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import pack_cluster

    cfg = planner.config
    if hasattr(observation, "pack"):  # ColumnarStore / ColumnarObservation
        packed, meta = observation.pack(
            pdbs,
            priority_threshold=cfg.priority_threshold,
            delete_non_replicated=cfg.delete_non_replicated_pods,
            pad_candidates=planner._pad_c,
            pad_spot=planner._pad_s,
            pad_slots=planner._pad_k,
        )
    else:
        packed, meta = pack_cluster(
            observation,
            pdbs,
            resources=cfg.resources,
            delete_non_replicated=cfg.delete_non_replicated_pods,
            pad_candidates=planner._pad_c,
            pad_spot=planner._pad_s,
            pad_slots=planner._pad_k,
        )
    planner._pad_c = max(planner._pad_c, packed.slot_req.shape[0])
    planner._pad_k = max(planner._pad_k, packed.slot_req.shape[1])
    planner._pad_s = max(planner._pad_s, packed.spot_free.shape[0])
    planner.last_packed = packed
    return packed, meta
