"""The planner: pack -> resident upload -> union solve (or a mesh
tier) -> selection or drain schedule -> decode.

The port of the JAX package's ``planner/solver_planner.SolverPlanner``.
Selection reproduces the reference's loop policy
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

``config.solver`` is ``"torch"`` (the union on ``device``),
``"sharded"`` (first-fit and best-fit over the 2-D device mesh,
``parallel/sharded_ffd.plan_ffd_sharded``, under the union) or
``"numpy"`` (the host oracles, ``solver/numpy_oracle``; no device is
touched). The union is ``solver/fallback.union_program`` with the
kernels on: its greedy passes are kernels B1/B2 (``ops/ffd_kernels``) on
the card and their plain versions on the CPU.

The dispatch ladder (``_maybe_shard``, on ``solver/memory.pick_tier``):
past one device's budget, and with more than one device in
``devices``, the solve reroutes to the cand-sharded union (each lane
block's union, repair intact, on its device), the same with
spot-chunked repair, the carry-streamed narrow union (kernels B3/B4 a
block), and last the 2-D layout without repair (``repair_unavailable``).
The resident cache, the staged solve and the drain schedule serve the
single-device program only: a reroute drops the cache (the next
single-device tick uploads in full) and ``plan_schedule`` returns None
(the controller then plans per tick). ``devices`` defaults to every
visible card for a CUDA ``device`` and ``[cpu]`` otherwise; a list may
name one card several times, so every rung runs its kernels on one
card. The planner packs a classified ``NodeMap`` (the object path) or a
``models/columnar`` mirror (``accepts_columnar``: the controller's
default observe path); both pack to the same tensors.
"""

from __future__ import annotations

import functools
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
from k8s_spot_rescheduler_tpu_torch.parallel.mesh import (
    default_devices,
    make_cand_mesh,
    make_mesh,
)
from k8s_spot_rescheduler_tpu_torch.parallel.sharded_ffd import (
    make_sharded_planner,
    plan_ffd_sharded,
    plan_union_cand_sharded,
)
from k8s_spot_rescheduler_tpu_torch.solver import carry as carry_mod
from k8s_spot_rescheduler_tpu_torch.solver import memory
from k8s_spot_rescheduler_tpu_torch.solver import schedule as sched_mod
from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
    union_program,
    with_best_fit_fallback,
    with_repair,
)
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
    """The production Planner (``solver="torch"`` or ``"sharded"``), or
    the host oracle behind the same surface (``solver="numpy"``).

    ``device`` defaults to ``cuda`` (raises without a card); ``devices``
    (every visible card of ``device``'s type when None) are the mesh the
    sharded solver and the ladder's rungs lay out. A
    ``solver="numpy"`` planner runs on the host and ignores both."""

    # plans straight from a ColumnarStore snapshot (the vectorized observe
    # path); the control loop checks this before handing it one instead
    # of a NodeMap
    accepts_columnar = True

    def __init__(self, config: Optional[ReschedulerConfig] = None, *,
                 device=None, devices=None):
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
        # what the last plan's dispatch decided: (label, repair_dropped,
        # repair_chunks, carry_chunks, carry_bytes)
        self.last_dispatch = None
        # the ladder's reroutes, built at first use
        self._fused_sharded = None
        self._fused_cand_sharded = {}
        self._fused_carry = {}
        self._mesh_shape = ()
        if cfg.solver == "numpy":
            self.device = torch.device("cpu")
            self.devices = [self.device]
            self.union = None
            self._fused = None
            return
        self.device = resolve_device(device)
        self.devices = (
            list(devices) if devices is not None
            else default_devices(self.device)
        )
        self.union = self._make_union(cfg.solver)
        self._fused = make_fused_planner(self.union)
        self._staged = StagedPlanner(
            self.union,
            chunk_lanes=cfg.staged_chunk_lanes,
            early_exit=cfg.staged_early_exit,
        )

    # ------------------------------------------------------------------
    # the solver programs and the dispatch ladder

    def _rounds(self) -> int:
        cfg = self.config
        return cfg.repair_rounds if cfg.fallback_best_fit else 0

    def _make_union(self, name: str):
        """The configured union: ``union_program`` with the kernels for
        ``"torch"``; for ``"sharded"`` the same composition over the 2-D
        solve (first-fit, best-fit, then repair on the mesh's first
        device)."""
        if name == "torch":
            return union_program(
                self._rounds(), self.config.fallback_best_fit,
                use_kernel=True,
            )
        if name != "sharded":
            raise ValueError(f"unknown solver {name!r}")
        shape = self.config.mesh_shape
        base = make_sharded_planner(
            shape if tuple(shape) != (1, 1) else None, self.devices)
        cfg = self.config
        if cfg.fallback_best_fit and cfg.repair_rounds > 0:
            return with_repair(base, cfg.repair_rounds)
        if cfg.fallback_best_fit:
            return with_best_fit_fallback(base)
        return base

    def _mesh(self):
        """The 2-D mesh of ``mesh_shape`` ((1, 1): inferred) over
        ``devices``."""
        shape = self.config.mesh_shape
        return make_mesh(shape if tuple(shape) != (1, 1) else None,
                         self.devices)

    def _sharded_fused_planner(self):
        """The 2-D (cand x spot) reroute: first-fit ∪ best-fit over the
        mesh, without repair (a lane's repair needs its whole spot axis
        on one device). ``_maybe_shard`` lands here only past even the
        carry-streamed lane block."""
        if self._fused_sharded is None:
            mesh = self._mesh()
            base = functools.partial(plan_ffd_sharded, mesh)
            self._mesh_shape = tuple(mesh.devices.shape)
            self._fused_sharded = make_fused_planner(
                with_best_fit_fallback(base)
                if self.config.fallback_best_fit
                else base
            )
        return self._fused_sharded

    def _cand_sharded_fused_planner(self, repair_chunks: int = 1):
        """The cand-only reroute: lanes split over every device, the
        spot axis replicated, each block's whole union (repair intact,
        spot-chunked when ``repair_chunks`` > 1) on its device. One
        planner per chunk count."""
        if repair_chunks not in self._fused_cand_sharded:
            cfg = self.config
            self._fused_cand_sharded[repair_chunks] = make_fused_planner(
                functools.partial(
                    plan_union_cand_sharded,
                    make_cand_mesh(self.devices),
                    rounds=self._rounds(),
                    best_fit_fallback=cfg.fallback_best_fit,
                    repair_spot_chunks=repair_chunks,
                    use_kernel=True,
                )
            )
        return self._fused_cand_sharded[repair_chunks]

    def _carry_streamed_fused_planner(self, carry_chunks: int, layout):
        """The carry-streamed cand tier: lanes split over every device,
        each block's narrow delta-carry streamed union (B3 first-fit
        over ``carry_chunks`` spot chunks, B4 best-fit, spot-chunked
        repair) under ``layout``. One planner per (chunks, layout)."""
        key = (carry_chunks, layout)
        if key not in self._fused_carry:
            cfg = self.config
            self._fused_carry[key] = make_fused_planner(
                functools.partial(
                    plan_union_cand_sharded,
                    make_cand_mesh(self.devices),
                    rounds=self._rounds(),
                    best_fit_fallback=cfg.fallback_best_fit,
                    carry_chunks=carry_chunks,
                    carry_layout=layout,
                    use_kernel=True,
                )
            )
        return self._fused_carry[key]

    def _maybe_shard(self, packed):
        """Pick the program for this problem's shapes: the configured
        union; past one device's budget, the cand-sharded union (repair
        intact) when a lane block fits a device; past that, the same
        with spot-chunked repair (``solver/memory.pick_repair_chunks``);
        past the wide chunked ceiling, the carry-streamed tier (narrow
        carries sized by the pack's exact layout guard,
        ``solver/carry.carry_layout``, at ``pick_carry_chunks``' count
        or the ``carry_chunks`` knob); only past even that, the 2-D
        layout without repair, the one rung ``repair_unavailable`` fires
        on. The decision is ``solver/memory.pick_tier``. Returns (fused,
        label, repair_dropped, repair_chunks, carry_chunks,
        carry_bytes)."""
        cfg = self.config
        wants_repair = cfg.fallback_best_fit and cfg.repair_rounds > 0
        own_chunks = 1 if wants_repair else 0
        if (
            not cfg.auto_shard
            or self._fused is None
            or cfg.solver == "sharded"  # already the mesh path
        ):
            return self._fused, cfg.solver, False, own_chunks, 0, -1
        n_devices = len(self.devices)
        C, K, S, R, W, A = memory.packed_shapes(packed)
        # deferred and memoized: the exact layout guard is an O(C*K*R)
        # host pass that only the carry rung pays, once a dispatch
        layout_memo = []

        def _layout():
            if not layout_memo:
                layout_memo.append(carry_mod.carry_layout(packed))
            return layout_memo[0]

        tier = memory.pick_tier(
            C, K, S, R, W, A,
            n_devices=n_devices,
            budget_bytes=cfg.solver_hbm_budget or None,
            wants_repair=wants_repair,
            carry_plane_bytes=lambda: carry_mod.plane_bytes(
                _layout(), R, A
            ),
            forced_carry_chunks=cfg.carry_chunks,
        )
        if tier.kind == "single":
            return (self._fused, cfg.solver, False, own_chunks, 0,
                    tier.carry_bytes)
        if tier.kind == "cand":
            log.info(
                "Problem exceeds single-device memory; dispatching to "
                "cand-sharded union over %d devices (%d-lane blocks, "
                "est %.1f GB/device; repair intact)",
                n_devices, tier.lane_block, tier.est_bytes / 1e9,
            )
            return (self._cand_sharded_fused_planner(),
                    f"{cfg.solver}+cand-sharded", False, own_chunks, 0,
                    tier.carry_bytes)
        if tier.kind == "cand-chunked":
            log.info(
                "Problem exceeds single-device memory; dispatching to "
                "cand-sharded union with repair chunked over %d spot "
                "chunks (est %.1f GB/device; repair intact)",
                tier.repair_chunks, tier.est_bytes / 1e9,
            )
            return (self._cand_sharded_fused_planner(tier.repair_chunks),
                    f"{cfg.solver}+cand-sharded", False, tier.repair_chunks,
                    0, tier.carry_bytes)
        if tier.kind == "cand-carry":
            layout = _layout()  # memoized: computed once a dispatch
            log.info(
                "Problem exceeds the wide chunked ceiling; dispatching "
                "to cand-sharded CARRY-STREAMED union over %d devices "
                "(%d-lane blocks, %d carry chunks, layout %s/%s/%s, "
                "est %.1f GB/device of which carries %.1f GB; repair "
                "intact)",
                n_devices, tier.lane_block, tier.carry_chunks,
                layout.used, layout.count, layout.aff,
                tier.est_bytes / 1e9, tier.carry_bytes / 1e9,
            )
            return (
                self._carry_streamed_fused_planner(tier.carry_chunks, layout),
                f"{cfg.solver}+cand-carry", False, tier.repair_chunks,
                tier.carry_chunks, tier.carry_bytes,
            )
        fused = self._sharded_fused_planner()
        log.info(
            "Problem exceeds single-device memory (even the narrow "
            "carry-streamed 1/%d lane block exceeds it); dispatching to "
            "2-D mesh-sharded solver (%s mesh); repair phase "
            "unavailable at this scale",
            n_devices, "x".join(map(str, self._mesh_shape)),
        )
        return (fused, f"{cfg.solver}+sharded", wants_repair, 0, 0,
                tier.carry_bytes)

    def _dispatch(self, packed):
        """Start the solve of a host pack: the ladder's pick, then the
        single-device program through the resident cache (staged when
        ``staged_chunk_lanes`` > 0) or a reroute on the host pack, whose
        blocks go straight to their devices. Sets ``last_dispatch``;
        returns ``fetch``, a zero-argument callable that blocks and
        returns (Selection, StagedStats or None)."""
        cfg = self.config
        fused, label, dropped, repair_chunks, carry_chunks, carry_bytes = (
            self._maybe_shard(packed))
        self.last_dispatch = (label, dropped, repair_chunks, carry_chunks,
                              carry_bytes)
        if fused is not self._fused or cfg.solver != "torch":
            # a mesh program places its own blocks: the resident cache
            # would pin a near-budget tensor set on the device exactly
            # when the mesh needs the room
            self._device_packed = None
            self._host_prev = None
            self.last_upload = (-1, False, -1)  # no resident upload
            if fused is self._fused:  # the configured "sharded" solver:
                # its repair reads the whole pack on the mesh's first device
                packed = to_device(packed, self.devices[0])
            pending_vec = fused(packed)
            return lambda: (decode_selection(pending_vec), None)
        with tracing.span("plan.delta-upload") as up_sp:
            device_packed = self.upload(packed)
            delta_lanes, full_repack, upload_bytes = self.last_upload
            if up_sp is not None:
                up_sp.attrs["delta_bytes"] = int(upload_bytes)
                up_sp.attrs["lanes"] = int(delta_lanes)
                if full_repack:
                    up_sp.attrs["full_repack"] = True
        if cfg.staged_chunk_lanes > 0:
            # blocks on the small prefilter fetch, then the first chunk
            # is already solving while the caller's host work (the
            # controller's metrics pass) runs
            run = self._staged.start(device_packed)
            return lambda: self._staged.finish_run(run)
        pending_vec = self._fused(device_packed)
        return lambda: (decode_selection(pending_vec), None)

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
        """Selection for a host pack, through the dispatch ladder: on the
        single-device program staged (chunked, early exit) when
        ``staged_chunk_lanes`` > 0, else the fused full solve. Returns
        ``solver/select.Selection``; ``last_dispatch`` and
        ``last_solver`` name the program."""
        sel, self.last_stats = self._dispatch(packed)()
        self.last_solver = self.last_dispatch[0]
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

    def _schedules(self, packed) -> bool:
        """Whether this pack's drain schedule can be cut: the schedule
        program is the single-device union's, so not for the configured
        ``"sharded"`` solver nor once the ladder leaves its single
        tier (per-tick planning then takes over: the same drains, one
        fetch each)."""
        if self.union is None:
            return True
        if self.config.solver != "torch":
            log.vlog(2, "solver %r has no drain-schedule program; planning "
                     "per tick", self.config.solver)
            return False
        if self._maybe_shard(packed)[0] is not self._fused:
            log.vlog(2, "mesh reroute engaged; drain schedules unavailable "
                     "at this scale — planning per tick")
            return False
        return True

    def plan_schedule_packed(self, packed, horizon: Optional[int] = None):
        """The drain schedule for a host pack: (decoded steps, the
        int32 [horizon, 3 + K] matrix as numpy), one fetch; None where
        no schedule can be cut (``_schedules``)."""
        horizon = max(
            1, self.config.schedule_horizon if horizon is None else horizon
        )
        if not self._schedules(packed):
            return None
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

        fetch = None
        delta_lanes, full_repack, upload_bytes = -1, False, -1
        label, repair_dropped = cfg.solver, False
        repair_chunks = (
            1 if cfg.fallback_best_fit and cfg.repair_rounds > 0 else 0
        )
        carry_chunks, carry_bytes = 0, -1
        if self.union is not None:
            fetch = self._dispatch(packed)
            delta_lanes, full_repack, upload_bytes = self.last_upload
            (label, repair_dropped, repair_chunks, carry_chunks,
             carry_bytes) = self.last_dispatch

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

            # solver-mode observability: what actually ran, and whether
            # the repair phase the config asked for was available on it
            # (only the 2-D reroute drops it); /healthz mirrors the same
            # verdict beside solver_mode
            from k8s_spot_rescheduler_tpu_torch.loop import health
            from k8s_spot_rescheduler_tpu_torch.metrics import (
                registry as metrics,
            )

            metrics.update_solver_mode(
                cfg.solver, label, repair_dropped,
                repair_chunks=repair_chunks,
                carry_chunks=carry_chunks,
                carry_bytes=carry_bytes,
            )
            health.STATE.note_solver_mode(label, carry_chunks, carry_bytes)

            self.last_solver = label
            return PlanReport(
                plan=plan,
                n_candidates=meta.n_candidates,
                n_feasible=n_feasible,
                solve_seconds=time.perf_counter() - t0,
                solver=label,
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
                carry_chunks=carry_chunks,
            )

        return finish

    def plan_schedule(self, observation, pdbs: Sequence[PDBSpec]):
        """Cut a whole drain schedule in ONE fetch: pack, run the
        drain -> commit -> re-solve loop (solver/schedule.py) and return
        a ``planner/schedule.DrainSchedule`` the control loop executes
        across ticks with per-step live validation on this planner's
        device. None where no schedule can be cut (``_schedules``): the
        configured ``"sharded"`` solver, or a problem the ladder
        reroutes; the caller then plans per tick."""
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
            if not self._schedules(packed):
                return None
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
