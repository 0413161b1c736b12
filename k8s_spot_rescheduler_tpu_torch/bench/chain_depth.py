"""Chain-depth DEMAND analysis.

The port of the JAX package's ``bench/chain_depth.py``. The repair
search executes relocation chains up to depth 2; three-link chains are
the published quality boundary (``chain3`` pools: shipped 0.750 of the
ILP by construction). This module measures how deep a chain the optimum
actually needs on organic problems: for every candidate lane of every
tick of a run, it classifies the MINIMUM mechanism that proves the
lane's drain:

- ``greedy``: first-fit or best-fit proves it (depth 0);
- ``depth1``: the depth-1-only repair variant proves it
  (``plan_repair(..., chain=False)``), one relocation, no chain;
- ``depth2``: the shipped depth-2 chained search proves it;
- ``deeper``: the single-lane ILP proves the drain possible but the
  depth-2 search cannot find it (demand for depth 3 or more, or for a
  depth-2 move sequence outside the rotation schedule);
- ``infeasible``: the ILP proves no valid placement exists at all.

The expensive ILP only runs on lanes the cheap passes left unresolved.

Unlike the JAX module, which pins itself to the CPU and plans on the
numpy oracle, this one runs where ``device`` says (``cuda`` unless the
caller passes ``cpu``): greedy is kernels B1 and B2
(``ops/ffd_kernels.plan_ffd_kernel``) on the card, their plain versions
only on CPU tensors; depth 1 and depth 2 are ``solver/repair.plan_repair``
on the same device; the drives plan with ``solver="torch"``, so the
same drains come off the card.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    to_device,
)

# the single-lane view (C=1) is exact because lanes are independent
# fork copies; one shared slicer (solver/schedule.py) serves this
# analyzer and the schedule execution handle's per-step validation
from k8s_spot_rescheduler_tpu_torch.solver.schedule import (  # noqa: F401
    slice_lane as _slice_lane,
)


def classify_packed(
    packed: PackedCluster,
    *,
    rounds: int = 8,
    ilp_time_limit: float = 60.0,
    device=None,
) -> Counter:
    """Per-lane minimal-mechanism classification for one tick's host
    pack. The device passes (greedy, depth-1, depth-2) run over all
    lanes at once on ``device``; the per-lane ILP
    (bench/quality.ilp_max_drains on a C=1 slice of the host pack) runs
    only for lanes depth-2 left unproven."""
    from k8s_spot_rescheduler_tpu_torch.bench.quality import ilp_max_drains
    from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import plan_ffd_kernel
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair

    valid = np.asarray(packed.cand_valid)
    counts: Counter = Counter()
    if not valid.any():
        return counts
    dev = to_device(packed, device)
    ff = plan_ffd_kernel(dev).feasible.cpu().numpy()
    bf = plan_ffd_kernel(dev, best_fit=True).feasible.cpu().numpy()
    greedy = ff | bf
    d1 = plan_repair(dev, rounds=rounds, chain=False).feasible.cpu().numpy()
    d2 = plan_repair(dev, rounds=rounds).feasible.cpu().numpy()
    for c in np.flatnonzero(valid):
        if greedy[c]:
            counts["greedy"] += 1
        elif d1[c]:
            counts["depth1"] += 1
        elif d2[c]:
            counts["depth2"] += 1
        else:
            ilp = ilp_max_drains(
                _slice_lane(packed, int(c)), time_limit=ilp_time_limit
            )
            if ilp is None:
                counts["ilp-failed"] += 1
            elif ilp > 0:
                counts["deeper"] += 1
            else:
                counts["infeasible"] += 1
    return counts


class _PackedTap:
    """Collects each planner tick's packed problem id-deduplicated, so a
    drive loop can classify exactly the problems the controller solved."""

    def __init__(self, device=None) -> None:
        self.counts: Counter = Counter()
        self.ticks = 0
        self.device = device
        self._last_id: Optional[int] = None

    def __call__(self, packed: Optional[PackedCluster]) -> None:
        if packed is None or id(packed) == self._last_id:
            return
        self._last_id = id(packed)
        self.ticks += 1
        self.counts += classify_packed(packed, device=self.device)


def analyze_quality_runs(
    seeds=range(3), configs: Optional[Dict] = None, *, device=None
) -> Dict[str, Counter]:
    """Chain-depth demand over the organic quality configs: every tick
    of every drain-to-exhaustion run, every valid lane classified.
    Returns {config name: Counter}. The chain3 BOUNDARY config is the
    deliberate positive control (its lanes demand depth 3 by
    construction); the bench reports it separately, never mixed into
    the organic rows."""
    from k8s_spot_rescheduler_tpu_torch.bench.quality import (
        drain_to_exhaustion,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        QUALITY_CONFIGS,
        generate_quality_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    out: Dict[str, Counter] = {}
    for name, spec in (configs or QUALITY_CONFIGS).items():
        total: Counter = Counter()
        for seed in seeds:
            tap = _PackedTap(device)
            client = generate_quality_cluster(
                spec, seed, reschedule_evicted=True
            )
            drain_to_exhaustion(
                client,
                ReschedulerConfig(solver="torch", resources=spec.resources),
                on_packed=tap,
                device=device,
            )
            total += tap.counts
        out[name] = total
    return out


def analyze_replay(
    *, n_events: int = 300, seed: int = 0, constrained: bool = True,
    device=None,
) -> Counter:
    """Chain-depth demand under churn: the constrained replay (spot
    interruptions × the full predicate surface), every tick's lanes
    classified."""
    from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    tap = _PackedTap(device)
    run_replay(
        ReschedulerConfig(solver="torch"),
        n_events=n_events,
        seed=seed,
        constrained=constrained,
        on_packed=tap,
        device=device,
    )
    return tap.counts
