"""The single-device planner: pack -> resident upload -> union solve ->
selection or drain schedule -> decode.

The port of the JAX package's ``planner/solver_planner.SolverPlanner``
on one device. Selection reproduces the reference's loop policy
(reference rescheduler.go:228-287): candidates are in least-requested-CPU
order and the first feasible one is drained.

- the Planner surface: ``plan``, ``plan_async`` (pack, delta upload and
  dispatch of the staged solve's first chunk; ``finish`` fetches) and
  ``plan_schedule`` (a ``planner/schedule.DrainSchedule`` cut in one
  fetch), with the why-no-drain report (``_report_conservatism``), the
  fetch accounting (``fetches_total``, ``schedule_lens``) and the
  high-water pads (``_pad_c/_pad_k/_pad_s``) the host pack grows;
- a resident device cache: the previous tick's problem tensors stay on
  the device, each tick's host pack is diffed against the previous one
  (``models/delta.emit_packed_delta``) and only the changed lanes,
  validity bits and spot rows are written in place. The delta goes
  unpadded: the reference pads it to power-of-two lengths so its jitted
  scatter keeps a few shapes, which eager PyTorch does not need. Shape
  growth, or a delta whose apply fails part way, re-uploads in full;
- ``plan_packed`` and ``plan_schedule_packed``: the same solves from a
  host pack, for callers that pack themselves.

``config.solver`` is ``"torch"`` (the union on ``device``) or
``"numpy"`` (the host oracles, ``solver/numpy_oracle``; no device is
touched). The union is ``solver/fallback.union_program`` with the
kernels on: its greedy passes are kernels B1/B2 (``ops/ffd_kernels``) on
the card and their plain versions on the CPU. With one device the JAX
package's dispatch ladder (``solver/memory.pick_tier``) always answers
"single", so this is the union it runs; the carry-streamed union
(kernels B3/B4) is its per-device block program on the sharded tiers.
The planner packs a classified ``NodeMap`` (the object path) or a
``models/columnar`` mirror (``accepts_columnar``: the controller's
default observe path); both pack to the same tensors.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.models.cluster import PDBSpec
from k8s_spot_rescheduler_tpu_torch.models.delta import (
    DELTA_FIELDS,
    emit_packed_delta,
)
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    host_array,
    to_device,
)
from k8s_spot_rescheduler_tpu_torch.planner.base import (
    PlanReport,
    pack_observation,
)
from k8s_spot_rescheduler_tpu_torch.solver import schedule as sched_mod
from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
from k8s_spot_rescheduler_tpu_torch.solver.select import (
    StagedPlanner,
    decode_selection,
    make_fused_planner,
)
from k8s_spot_rescheduler_tpu_torch.utils import logging as log
from k8s_spot_rescheduler_tpu_torch.utils import tracing
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig


def _observe_source(observation) -> str:
    """The observe path a pack came from, for the ``plan.pack`` span's
    ``source`` attribute (a structural key: the flight recorder keeps its
    value unredacted)."""
    return "columnar" if hasattr(observation, "pack") else "objects"


class TorchSolverPlanner:
    """The production Planner on one device (``solver="torch"``), or
    the host oracle behind the same surface (``solver="numpy"``).

    ``device`` defaults to ``cuda`` (raises without a card); a
    ``solver="numpy"`` planner runs on the host and ignores it."""

    # plans straight from a ColumnarStore snapshot (the vectorized observe
    # path); the control loop checks this before handing it one instead
    # of a NodeMap
    accepts_columnar = True

    def __init__(self, config: Optional[ReschedulerConfig] = None, *,
                 device=None):
        self.config = cfg = config or ReschedulerConfig()
        # high-water pads (planner/base.pack_observation grows them):
        # shapes only ever grow, so the resident cache keeps diffing
        self._pad_c = 0
        self._pad_s = 0
        self._pad_k = cfg.max_pods_per_node_hint
        self.last_packed = None
        self.last_solver = cfg.solver  # what the last plan actually ran
        self.fetches_total = 0  # blocking planner fetches (plan + schedule)
        self.schedule_lens = []  # steps per cut schedule, this planner's life
        self._device_packed = None
        self._host_prev = None
        self.last_upload = None  # (delta_lanes, full_repack, upload_bytes)
        self.last_stats = None  # StagedStats of the last staged plan
        if cfg.solver == "numpy":
            self.device = torch.device("cpu")
            self.union = None
            return
        self.device = resolve_device(device)
        self.union = union_program(
            cfg.repair_rounds if cfg.fallback_best_fit else 0,
            cfg.fallback_best_fit,
            use_kernel=True,
        )
        self._fused = make_fused_planner(self.union)
        self._staged = StagedPlanner(
            self.union,
            chunk_lanes=cfg.staged_chunk_lanes,
            early_exit=cfg.staged_early_exit,
        )

    # ------------------------------------------------------------------
    # resident device cache

    def _apply_delta(self, delta) -> int:
        """Write a delta into the resident tensors in place; returns the
        bytes copied host -> device."""
        sent = 0
        for field, idx_name, data_name in DELTA_FIELDS:
            idx = getattr(delta, idx_name)
            if not len(idx):
                continue
            rows = torch.from_numpy(idx.astype(np.int64)).to(self.device)
            vals = torch.from_numpy(
                host_array(field, getattr(delta, data_name))
            ).to(self.device)
            getattr(self._device_packed, field).index_copy_(0, rows, vals)
            sent += rows.numel() * 8 + vals.numel() * vals.element_size()
        return sent

    def upload(self, packed) -> PackedCluster:
        """This tick's host pack on the device, through the resident
        cache. Records (delta_lanes, full_repack, upload_bytes) in
        ``last_upload``; delta_lanes is -1 on a full upload.

        A delta writes field by field, so a copy that raises part way
        leaves the resident tensors half new: the cache is then dropped
        and the pack uploaded in full, as the reference re-uploads after
        a failed donated scatter (its ``_upload_incremental``)."""
        if not self.config.incremental_device_cache:
            self.last_upload = (-1, True, _nbytes(packed))
            return to_device(packed, self.device)
        delta = None
        if self._device_packed is not None and self._host_prev is not None:
            delta = emit_packed_delta(self._host_prev, packed)
        if delta is not None:
            try:
                sent = self._apply_delta(delta)
                self._host_prev = packed
                self.last_upload = (delta.n_lanes, False, sent)
                return self._device_packed
            except Exception as err:  # noqa: BLE001 — the cache may be half written: rebuild it from scratch
                log.error("delta apply failed (%s); full re-upload", err)
                self._device_packed = None
                self._host_prev = None
        self._device_packed = to_device(packed, self.device)
        self._host_prev = packed
        self.last_upload = (-1, True, _nbytes(packed))
        return self._device_packed

    # ------------------------------------------------------------------
    # from a host pack

    def plan_packed(self, packed):
        """Selection for a host pack: staged (chunked, early exit) when
        ``staged_chunk_lanes`` > 0, else the fused full solve. Returns
        ``solver/select.Selection``."""
        device_packed = self.upload(packed)
        if self.config.staged_chunk_lanes > 0:
            sel, self.last_stats = self._staged.solve(device_packed)
        else:
            sel = decode_selection(self._fused(device_packed))
            self.last_stats = None
        self.fetches_total += 1
        return sel

    def _schedule_matrix(self, packed, horizon: int) -> np.ndarray:
        """The int32 [horizon, 3 + K] schedule of a host pack: on the
        device through the resident cache (the schedule reads the cached
        tensors and writes none, so the next tick's diff still holds),
        one fetch; or the host oracle."""
        cfg = self.config
        if self.union is None:
            return sched_mod.plan_schedule_oracle(
                packed,
                horizon,
                best_fit_fallback=cfg.fallback_best_fit,
                repair_rounds=cfg.repair_rounds,
            )
        with tracing.span("plan.delta-upload"):
            device_packed = self.upload(packed)
        with tracing.span("plan.solve"):
            return sched_mod.make_schedule_planner(self.union, horizon)(
                device_packed
            ).cpu().numpy()  # the ONE fetch for up to `horizon` drains

    def plan_schedule_packed(self, packed, horizon: Optional[int] = None):
        """The drain schedule for a host pack: (decoded steps, the
        int32 [horizon, 3 + K] matrix as numpy). One fetch."""
        horizon = max(
            1, self.config.schedule_horizon if horizon is None else horizon
        )
        mat = self._schedule_matrix(packed, horizon)
        self.fetches_total += 1
        return sched_mod.decode_schedule(mat), mat

    # ------------------------------------------------------------------
    # the Planner surface

    def _pack_observation(self, observation, pdbs):
        """The shared pack path (planner/base.pack_observation): used
        by plan_async, plan_schedule, and the drain-schedule execution
        handle, whose per-step live re-pack must be exactly what a
        fresh plan would solve."""
        return pack_observation(self, observation, pdbs)

    def plan(self, observation, pdbs: Sequence[PDBSpec]) -> PlanReport:
        """``observation`` is a classified ``NodeMap``."""
        return self.plan_async(observation, pdbs)()

    def plan_async(self, observation, pdbs: Sequence[PDBSpec]):
        """The pipelined half-tick: pack on the host, write the delta (or
        the full problem) to the device, and dispatch the staged solve's
        prefilter and first chunk. The returned zero-arg ``finish``
        callable blocks on the small selection fetches and builds the
        PlanReport; the control loop runs its host-side metrics pass
        between the two."""
        t0 = time.perf_counter()
        cfg = self.config
        # spans land on the controller's ambient tick trace (no-ops
        # when tracing is off or no trace is active)
        with tracing.span("plan.pack") as pack_sp:
            packed, meta = self._pack_observation(observation, pdbs)
            if pack_sp is not None:
                pack_sp.attrs["lanes"] = int(packed.slot_req.shape[0])
                pack_sp.attrs["source"] = _observe_source(observation)

        for blocked in meta.blocking_pods():
            log.info("BlockingPod: %s (%s)", blocked.pod.uid, blocked.reason)

        repair_chunks = (
            1 if cfg.fallback_best_fit and cfg.repair_rounds > 0 else 0
        )
        fetch = None
        delta_lanes, full_repack, upload_bytes = -1, False, -1
        if self.union is not None:
            with tracing.span("plan.delta-upload") as up_sp:
                device_packed = self.upload(packed)
                delta_lanes, full_repack, upload_bytes = self.last_upload
                if up_sp is not None:
                    up_sp.attrs["delta_bytes"] = int(upload_bytes)
                    up_sp.attrs["lanes"] = int(delta_lanes)
                    if full_repack:
                        up_sp.attrs["full_repack"] = True
            if cfg.staged_chunk_lanes > 0:
                staged = self._staged
                # blocks on the small prefilter fetch, then the first
                # chunk is already solving while the caller's host work
                # (the controller's metrics pass) runs
                run = staged.start(device_packed)

                def fetch(r=run):
                    return staged.finish_run(r)

            else:
                pending_vec = self._fused(device_packed)

                def fetch(pv=pending_vec):
                    return decode_selection(pv), None

        def finish() -> PlanReport:
            staged_stats = None
            # one blocking planner fetch per completed plan (device
            # selection fetch or host solve)
            self.fetches_total += 1
            with tracing.span("plan.solve"):
                if fetch is not None:
                    sel, staged_stats = fetch()
                    self.last_stats = staged_stats
                    plan = (
                        meta.build_plan(sel.index, sel.row)
                        if sel.found
                        else None
                    )
                    n_feasible = sel.n_feasible
                else:
                    from k8s_spot_rescheduler_tpu_torch.solver.numpy_oracle import (
                        plan_union_oracle,
                    )

                    result = plan_union_oracle(
                        packed,
                        best_fit_fallback=cfg.fallback_best_fit,
                        repair_rounds=cfg.repair_rounds,
                    )
                    feasible = np.asarray(result.feasible)
                    n_feasible = int(feasible.sum())
                    plan = None
                    if n_feasible:
                        c = int(np.argmax(feasible))
                        plan = meta.build_plan(
                            c, np.asarray(result.assignment[c])
                        )

            self._report_conservatism(packed, meta, n_feasible)

            # solver-mode observability: one device runs the single-chip
            # union, so the running solver is the configured one and the
            # repair phase is never dropped
            from k8s_spot_rescheduler_tpu_torch.loop import health
            from k8s_spot_rescheduler_tpu_torch.metrics import (
                registry as metrics,
            )

            metrics.update_solver_mode(
                cfg.solver, cfg.solver, False, repair_chunks=repair_chunks
            )
            health.STATE.note_solver_mode(cfg.solver, 0, -1)

            self.last_solver = cfg.solver
            return PlanReport(
                plan=plan,
                n_candidates=meta.n_candidates,
                n_feasible=n_feasible,
                solve_seconds=time.perf_counter() - t0,
                solver=cfg.solver,
                feasible_candidates=[plan] if plan else [],
                delta_pack_lanes=delta_lanes,
                full_repack=full_repack,
                upload_bytes=upload_bytes,
                chunks_solved=(
                    staged_stats.chunks_solved if staged_stats else -1
                ),
                chunks_skipped=(
                    staged_stats.chunks_skipped if staged_stats else 0
                ),
                count_truncated=(
                    staged_stats.count_truncated if staged_stats else False
                ),
                repair_chunks=repair_chunks,
                carry_chunks=0,
            )

        return finish

    def plan_schedule(self, observation, pdbs: Sequence[PDBSpec]):
        """Cut a whole drain schedule in ONE fetch: pack, run the
        drain -> commit -> re-solve loop (solver/schedule.py) and return
        a ``planner/schedule.DrainSchedule`` the control loop executes
        across ticks with per-step live validation on this planner's
        device."""
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
        from k8s_spot_rescheduler_tpu_torch.planner.schedule import (
            DrainSchedule,
        )

        cfg = self.config
        horizon = max(1, cfg.schedule_horizon)
        with tracing.span("plan.schedule") as sp:
            with tracing.span("plan.pack",
                              source=_observe_source(observation)):
                packed, meta = self._pack_observation(observation, pdbs)
            for blocked in meta.blocking_pods():
                log.info(
                    "BlockingPod: %s (%s)", blocked.pod.uid, blocked.reason
                )
            mat = self._schedule_matrix(packed, horizon)
            steps = sched_mod.decode_schedule(mat)
            self.fetches_total += 1
            self.schedule_lens.append(len(steps))
            metrics.update_plan_schedule_len(len(steps))
            # why-no-drain observability per cut: step 0's feasible
            # count IS the fresh solve's
            self._report_conservatism(
                packed, meta, steps[0].n_feasible if steps else 0
            )
            if sp is not None:
                sp.attrs["steps"] = len(steps)
                sp.attrs["horizon"] = horizon
        self.last_solver = cfg.solver
        return DrainSchedule(
            steps,
            packed,
            meta,
            pack_fn=self._pack_observation,
            solver_label=f"{cfg.solver}+schedule",
            horizon=horizon,
            base_observation=observation,
            device=self.device,
        )

    def _report_conservatism(self, packed, meta, n_feasible: int) -> None:
        """Why-no-drain observability (metrics/registry.py conservatism
        gauges): classify every non-drainable candidate. The reference
        only logs the blocking pod per node (rescheduler.go:232-238);
        here the safe-direction over-approximations (unmodeled
        constraints pack as placeable-nowhere) additionally surface as
        metrics."""
        from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

        by_reason = {"pdb": 0, "non-replicated": 0}
        for blocked in meta.blocking_pods():
            if blocked.reason.startswith("pod is not replicated"):
                by_reason["non-replicated"] += 1
            else:
                by_reason["pdb"] += 1
        unmodeled_mask = meta.unmodeled_candidate_mask()
        by_reason["unmodeled"] = int(unmodeled_mask.sum())
        cand_valid = np.asarray(packed.cand_valid)[: meta.n_candidates]
        by_reason["no-capacity"] = max(
            0,
            int(cand_valid.sum()) - n_feasible - by_reason["unmodeled"],
        )
        n_unplaceable = meta.unplaceable_pod_count()
        metrics.update_conservatism(n_unplaceable, by_reason)
        if n_feasible == 0 and any(by_reason.values()):
            log.vlog(
                2,
                "No drainable candidate: %d blocked (%s); %d unplaceable "
                "pod(s) on candidate nodes.",
                sum(by_reason.values()),
                ", ".join(f"{k}={v}" for k, v in sorted(by_reason.items()) if v),
                n_unplaceable,
            )


def _nbytes(packed) -> int:
    return sum(np.asarray(getattr(packed, f)).nbytes for f in packed._fields)
