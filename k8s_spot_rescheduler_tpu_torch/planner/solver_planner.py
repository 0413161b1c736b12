"""The single-device planning tick: resident upload -> union solve ->
selection or drain schedule -> decode.

The port of the single-chip half of the JAX package's
``planner/solver_planner.SolverPlanner``, from a host pack onward (the
host pack path itself is a later slice):

- a resident device cache: the previous tick's problem tensors stay on
  the device, each tick's host pack is diffed against the previous one
  (``models/delta.emit_packed_delta``) and only the changed lanes,
  validity bits and spot rows are written in place. The delta goes
  unpadded: the reference pads it to power-of-two lengths so its jitted
  scatter keeps a few shapes, which eager PyTorch does not need. Shape
  growth re-uploads in full;
- ``plan_packed``: the staged selection (``solver/select.StagedPlanner``)
  over the union, the counterpart of ``plan_async`` with schedules off;
- ``plan_schedule_packed``: the drain schedule
  (``solver/schedule.schedule_matrix``), the counterpart of
  ``plan_schedule``;
- ``fetches_total``: one per blocking planner fetch (a plan or a
  schedule), as in the reference.

The union is ``solver/fallback.union_program`` with the kernels on: its
greedy passes are kernels B1/B2 (``ops/ffd_kernels``) on the card and
their plain versions on the CPU. With one device the JAX package's
dispatch ladder (``solver/memory.pick_tier``) always answers "single",
so this is the union it runs; the carry-streamed union (kernels B3/B4)
is its per-device block program on the sharded tiers.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.models.delta import emit_packed_delta
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    host_array,
    to_device,
)
from k8s_spot_rescheduler_tpu_torch.solver import schedule as sched_mod
from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
from k8s_spot_rescheduler_tpu_torch.solver.select import (
    StagedPlanner,
    decode_selection,
    make_fused_planner,
)


@dataclasses.dataclass(frozen=True)
class PlannerConfig:
    """The planner knobs of ``ReschedulerConfig``, same names and
    defaults."""

    fallback_best_fit: bool = True
    repair_rounds: int = 8
    incremental_device_cache: bool = True
    staged_chunk_lanes: int = 256
    staged_early_exit: bool = True
    schedule_horizon: int = 32


# resident tensor <- (delta index section, delta data section)
_DELTA_MAP = (
    ("slot_req", "lanes", "lane_slot_req"),
    ("slot_valid", "lanes", "lane_slot_valid"),
    ("slot_tol", "lanes", "lane_slot_tol"),
    ("slot_aff", "lanes", "lane_slot_aff"),
    ("cand_valid", "cand_rows", "cand_valid"),
    ("spot_free", "spot_rows", "spot_free"),
    ("spot_count", "spot_rows", "spot_count"),
    ("spot_max_pods", "spot_rows", "spot_max_pods"),
    ("spot_taints", "spot_rows", "spot_taints"),
    ("spot_ok", "spot_rows", "spot_ok"),
    ("spot_aff", "spot_rows", "spot_aff"),
)


class TorchSolverPlanner:
    """Pack -> resident upload -> union solve -> decode, on one device.

    ``device`` defaults to ``cuda`` (raises without a card)."""

    def __init__(self, config: Optional[PlannerConfig] = None, *,
                 device=None):
        self.config = config or PlannerConfig()
        self.device = resolve_device(device)
        cfg = self.config
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
        self._device_packed = None
        self._host_prev = None
        self.fetches_total = 0
        self.last_upload = None  # (delta_lanes, full_repack, upload_bytes)
        self.last_stats = None  # StagedStats of the last staged plan

    # ------------------------------------------------------------------
    # resident device cache

    def _apply_delta(self, delta) -> int:
        """Write a delta into the resident tensors in place; returns the
        bytes copied host -> device."""
        sent = 0
        for field, idx_name, data_name in _DELTA_MAP:
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
        ``last_upload``; delta_lanes is -1 on a full upload."""
        if not self.config.incremental_device_cache:
            self.last_upload = (-1, True, _nbytes(packed))
            return to_device(packed, self.device)
        delta = None
        if self._device_packed is not None and self._host_prev is not None:
            delta = emit_packed_delta(self._host_prev, packed)
        if delta is not None:
            sent = self._apply_delta(delta)
            self._host_prev = packed
            self.last_upload = (delta.n_lanes, False, sent)
            return self._device_packed
        self._device_packed = to_device(packed, self.device)
        self._host_prev = packed
        self.last_upload = (-1, True, _nbytes(packed))
        return self._device_packed

    # ------------------------------------------------------------------
    # the tick

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

    def plan_schedule_packed(self, packed, horizon: Optional[int] = None):
        """The drain schedule for a host pack: (decoded steps, the
        int32 [horizon, 3 + K] matrix as numpy). One fetch."""
        horizon = max(1, self.config.schedule_horizon if horizon is None else horizon)
        device_packed = self.upload(packed)
        mat = sched_mod.make_schedule_planner(self.union, horizon)(
            device_packed
        ).cpu().numpy()  # the ONE fetch for up to `horizon` drains
        self.fetches_total += 1
        return sched_mod.decode_schedule(mat), mat


def _nbytes(packed) -> int:
    return sum(np.asarray(getattr(packed, f)).nbytes for f in packed._fields)
