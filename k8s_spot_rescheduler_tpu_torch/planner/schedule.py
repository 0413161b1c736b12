"""Drain-schedule execution: the host-side half of the device loop.

The port of the JAX package's ``planner/schedule.py``; the per-step
from-scratch validation runs on the owning planner's device.

``solver/schedule.py`` cuts a whole drain schedule in one device fetch
under the quiescent-cluster assumption; this module is the layer that
makes executing it SAFE. A :class:`DrainSchedule` wraps one cut
schedule plus the packed snapshot it was cut against, and the control
loop draws drains from it across ticks through ``next_plan`` — which,
per *executed* step:

1. **re-packs the live mirror** (the same observe path a fresh plan
   uses — the schedule never acts on stale tensors);
2. **checks the step's precondition**: the live pack must still match
   the schedule's *predicted* state — the base snapshot evolved by the
   host twin of the device commit (``commit_step_host``) — compared BY
   NODE NAME so the packer's re-sorting between ticks (spot probe
   order follows requested CPU, which the controller's own drains
   change) is not mistaken for churn. Compared surfaces: the candidate
   set and each remaining lane's slot requests/validity, and every
   spot node's free/count/max-pods/admission state. The interned
   taint/affinity WORDS are deliberately not compared across packs
   (their bit layouts are pack-relative); the admission surface is
   instead re-proven from scratch per step, below;
3. **re-proves the placement from scratch** (solver/validate.py)
   against the LIVE pack — the same proven-placement invariant every
   other path honors: a search (or prediction) bug can lose a drain,
   never strand a pod.

Any failed check *invalidates the schedule tail*: ``next_plan`` returns
None with ``invalidated`` set, the controller counts it
(``schedule_invalidated_total`` + a ``schedule-invalidated`` flight
event) and re-plans fresh. Churn costs a fetch, never a wrong eviction.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.planner.base import PlanReport
from k8s_spot_rescheduler_tpu_torch.solver.schedule import (
    ScheduleStep,
    commit_step_host,
    slice_lane,
)
from k8s_spot_rescheduler_tpu_torch.solver.validate import validate_assignment
from k8s_spot_rescheduler_tpu_torch.utils.syncs import device_sync


def _meta_names(meta):
    """(candidate node names, spot node names) for either meta flavor
    (models/tensors.PackMeta or models/columnar.ColumnarMeta)."""
    store = getattr(meta, "store", None)
    if store is not None:
        cand = [store.node_objs[int(r)].name for r in meta.cand_rows]
        spot = [store.node_objs[int(r)].name for r in meta.spot_rows]
    else:
        cand = [info.node.name for info in meta.candidates]
        spot = [info.node.name for info in meta.spot]
    return cand, spot


class DrainSchedule:
    """One cut drain schedule plus the machinery to execute it safely.

    ``pack_fn(observation, pdbs) -> (packed, meta)`` is the owning
    planner's observe->tensors path (high-water pads included), so the
    live pack a step validates against is exactly what a fresh plan
    would solve. ``on_step`` (optional) receives each served
    PlanReport — the quality benches' hint-recording hook. ``device``
    (required) is the owning planner's: each step's from-scratch
    validation runs there."""

    def __init__(
        self,
        steps: List[ScheduleStep],
        packed,
        meta,
        *,
        pack_fn: Callable,
        solver_label: str,
        horizon: int,
        device,
        base_observation=None,
    ):
        self.steps = steps
        self.cursor = 0
        self.invalidated = False
        self.invalid_reason = ""
        self.horizon = int(horizon)
        self.solver_label = solver_label
        self.on_step: Optional[Callable] = None
        self.device = device
        self._pack_fn = pack_fn
        self._base_packed = packed
        self._base_meta = meta
        self._base_observation = base_observation
        self._expected = packed  # evolves via commit_step_host
        cand, spot = _meta_names(meta)
        self._cand_names = cand
        self._spot_names = spot
        self._cand_index: Dict[str, int] = {n: i for i, n in enumerate(cand)}
        self._drained: set = set()

    # ------------------------------------------------------------------

    @property
    def meta(self):
        """The pack meta this schedule was cut with (read-only): its
        candidate and spot rows, names and blocking pods."""
        return self._base_meta

    @property
    def exhausted(self) -> bool:
        return self.cursor >= len(self.steps)

    def empty_report(self) -> PlanReport:
        """A no-drain report for a zero-step schedule (no candidate was
        drainable when it was cut) — the tick's metrics stay coherent."""
        return PlanReport(
            plan=None,
            n_candidates=self.meta.n_candidates,
            n_feasible=0,
            solve_seconds=0.0,
            solver=self.solver_label,
            schedule_len=0,
            schedule_step=-1,
        )

    def _invalidate(self, why: str) -> None:
        self.invalidated = True
        self.invalid_reason = why

    # ------------------------------------------------------------------

    def _precondition(self, live_packed, live_cand, live_spot) -> str:
        """'' when the live pack still matches the predicted state;
        otherwise the churn that broke it (the invalidation cause).
        Name-keyed: the packer's own re-sorting is not churn."""
        exp = self._expected
        base = self._base_packed
        live_cand_index = {n: i for i, n in enumerate(live_cand)}
        # candidate set: a new on-demand node (or a vanished live one)
        # changes what a fresh solve would choose from
        fresh = set(live_cand) - set(self._cand_names)
        if fresh:
            return f"candidate set changed: new node(s) {sorted(fresh)[:3]}"
        for name, i_base in self._cand_index.items():
            i_live = live_cand_index.get(name)
            if name in self._drained:
                # an executed drain's node either left the cluster (CA
                # collected it) or packs as an empty, invalid lane
                if i_live is not None and bool(
                    np.asarray(live_packed.slot_valid[i_live]).any()
                ):
                    return f"drained node {name} has pods again"
                continue
            if i_live is None:
                return f"candidate node {name} vanished"
            if bool(live_packed.cand_valid[i_live]) != bool(
                base.cand_valid[i_base]
            ):
                return f"candidate {name} drainability flipped"
            nb = int(np.asarray(base.slot_valid[i_base]).sum())
            nl = int(np.asarray(live_packed.slot_valid[i_live]).sum())
            if nb != nl:
                return f"candidate {name} pod count changed ({nb}->{nl})"
            if nb and not np.array_equal(
                np.asarray(live_packed.slot_req[i_live][:nb]),
                np.asarray(base.slot_req[i_base][:nb]),
            ):
                return f"candidate {name} pod requests changed"
        # spot pool: names + capacity surface vs the committed prediction
        live_spot_index = {n: i for i, n in enumerate(live_spot)}
        if set(live_spot) != set(self._spot_names):
            return "spot pool membership changed"
        for name, i_base in (
            (n, i) for i, n in enumerate(self._spot_names)
        ):
            i_live = live_spot_index[name]
            if (
                not np.array_equal(
                    np.asarray(live_packed.spot_free[i_live]),
                    np.asarray(exp.spot_free[i_base]),
                )
                or int(live_packed.spot_count[i_live])
                != int(exp.spot_count[i_base])
                or int(live_packed.spot_max_pods[i_live])
                != int(exp.spot_max_pods[i_base])
                or bool(live_packed.spot_ok[i_live])
                != bool(base.spot_ok[i_base])
            ):
                return f"spot node {name} state drifted from prediction"
        return ""

    def next_plan(self, observation, pdbs) -> Optional[PlanReport]:
        """Validate and serve the next schedule step against the LIVE
        observation. None means no step was served: ``invalidated``
        distinguishes churn (re-plan now) from plain exhaustion."""
        if self.invalidated or self.exhausted:
            return None
        t0 = time.perf_counter()
        step = self.steps[self.cursor]
        if self.cursor == 0 and observation is self._base_observation:
            # step 0, same tick, same observation object the schedule
            # was just cut from: the live pack IS the base pack (the
            # tick thread is the only mutator) — skip the re-pack, keep
            # the from-scratch proof below
            live_packed, live_meta = self._base_packed, self.meta
            live_cand, live_spot = self._cand_names, self._spot_names
        else:
            live_packed, live_meta = self._pack_fn(observation, pdbs)
            live_cand, live_spot = _meta_names(live_meta)
        why = self._precondition(live_packed, live_cand, live_spot)
        if why:
            self._invalidate(why)
            return None
        if not 0 <= step.index < len(self._cand_names):
            # a wire-decoded schedule's indices are frame-validated for
            # dtype/shape only; a corrupt VALUE must invalidate (counted,
            # re-planned), never negative-index into the candidate list
            self._invalidate(
                f"schedule step index {step.index} outside the "
                f"{len(self._cand_names)}-candidate base pack"
            )
            return None
        name = self._cand_names[step.index]
        c_live = live_cand.index(name) if name in live_cand else -1
        if c_live < 0:
            self._invalidate(f"scheduled candidate {name} vanished")
            return None
        # remap the placement row into the live pack's spot index space
        K_live = live_packed.slot_req.shape[1]
        live_spot_index = {n: i for i, n in enumerate(live_spot)}
        row_live = np.full(K_live, -1, np.int32)
        for k in range(min(len(step.row), K_live)):
            s = int(step.row[k])
            if s < 0:
                continue
            if s >= len(self._spot_names):
                self._invalidate("scheduled placement indexes a pad lane")
                return None
            s_live = live_spot_index.get(self._spot_names[s])
            if s_live is None:
                self._invalidate(
                    f"placement target {self._spot_names[s]} vanished"
                )
                return None
            row_live[k] = s_live
        # the invariant: EVERY executed step is re-proven from scratch
        # against the live pack (live taint/affinity words included)
        ok = validate_assignment(
            to_device(slice_lane(live_packed, c_live), self.device),
            torch.from_numpy(row_live[None]).to(self.device),
        )
        if not device_sync("step-validate", bool, ok[0]):
            self._invalidate(
                f"step {self.cursor} failed from-scratch validation "
                f"against the live pack"
            )
            return None
        plan = live_meta.build_plan(c_live, row_live)
        self._expected = commit_step_host(
            self._expected, step.index, step.row
        )
        self._drained.add(name)
        self.cursor += 1
        report = PlanReport(
            plan=plan,
            n_candidates=live_meta.n_candidates,
            n_feasible=step.n_feasible,
            solve_seconds=time.perf_counter() - t0,
            solver=self.solver_label,
            feasible_candidates=[plan],
            schedule_len=len(self.steps),
            schedule_step=self.cursor - 1,
        )
        if self.on_step is not None:
            self.on_step(report)
        return report
