"""Freeze full-size problems and the JAX package's answers for the port.

The PyTorch port (``k8s_spot_rescheduler_tpu_torch``) may not import the
JAX package, yet its chip smoke must run at the north-star shape and be
held against the reference. This script bridges the two once, on the
CPU: it packs ``io/synthetic.CONFIGS[n]`` (or ``CONTENDED``, below) at a
seed along the route ``bench.build_problem`` takes (generate -> columnar
mirror -> pack) and stores, beside the pack, what the JAX package
answers for it:

- ``selection``: ``make_fused_planner(with_repair(plan_ffd, 8))``, the
  unstaged selection vector ``[idx, found, n_feasible, row...]``;
- ``staged_selection``: ``StagedPlanner`` over the same union with the
  default ``chunk_lanes=256`` and early exit (what ``plan_async`` returns);
- ``schedule``: ``make_schedule_planner(..., 32)``, the ``[32, 3+K]``
  drain-schedule matrix;
- for ``CONTENDED`` also the lane-level answers of the union
  (``union_feasible``/``union_assignment``) and of ``plan_repair`` alone
  (``repair_feasible``/``repair_assignment``).

Configs 3 and 4 are uncontended: first-fit proves every valid lane, so
repair never runs on them. ``CONTENDED`` is the quality suite's
anti-affinity pools (``io/synthetic.AffinitySpec``: swap, depth-2
interlock and depth-3 chain pools) widened to 512 pools, 512 on-demand
and about 1,100 spot nodes: greedy proves 154 of its 512 lanes and
repair 307 more, so the chip smoke checks repair on the card with it.

Run from the repo root:

    JAX_PLATFORMS=cpu python -m tests.torch_port_fixtures 3 4 contended

It writes ``k8s_spot_rescheduler_tpu_torch/data/<name>_seed<seed>.npz``
(``config3``, ``config4``, ``contended``). The port's tests check that
each frozen pack still equals a fresh one.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from k8s_spot_rescheduler_tpu_torch.models.tensors import save_npz

HORIZON = 32
DATA_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "k8s_spot_rescheduler_tpu_torch",
    "data",
)


CONTENDED = "contended"


def contended_spec():
    """The contended problem: 512 anti-affinity quality pools."""
    from k8s_spot_rescheduler_tpu.io.synthetic import AffinitySpec

    return AffinitySpec(
        "quality-affinity-512g",
        n_groups=512,
        aswap_frac=0.4,
        interlock_frac=0.2,
        chain3_frac=0.1,
    )


def frozen_path(config_id, seed: int = 0) -> str:
    name = CONTENDED if config_id == CONTENDED else f"config{config_id}"
    return os.path.join(DATA_DIR, f"{name}_seed{seed}.npz")


def pack_config(config_id, seed: int = 0):
    """The numpy PackedCluster of synthetic config ``config_id`` (or
    ``CONTENDED``) at ``seed``, packed as ``bench.build_problem`` packs
    it."""
    from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS

    if config_id == CONTENDED:
        return pack_spec(contended_spec(), seed)
    return pack_spec(CONFIGS[config_id], seed)


def pack_spec(spec, seed: int = 0):
    """The numpy PackedCluster of a synthetic or quality spec at
    ``seed``: generate, attach the columnar mirror, pack."""
    from k8s_spot_rescheduler_tpu.io.synthetic import generate_quality_cluster
    from k8s_spot_rescheduler_tpu.utils.config import ReschedulerConfig

    cfg = ReschedulerConfig(resources=spec.resources)
    client = generate_quality_cluster(spec, seed)
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = store.pack(
        client.list_pdbs(), priority_threshold=cfg.priority_threshold
    )
    return packed


def jax_answers(packed, horizon: int = HORIZON) -> dict:
    """The JAX package's selection, staged selection and schedule for
    ``packed`` (the default union: first-fit, best-fit, 8 repair
    rounds)."""
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu.solver.schedule import make_schedule_planner
    from k8s_spot_rescheduler_tpu.solver.select import (
        StagedPlanner,
        make_fused_planner,
    )

    union = with_repair(plan_ffd, 8)
    selection = np.asarray(make_fused_planner(union)(packed), np.int32)
    sel, _ = StagedPlanner(union, chunk_lanes=256, early_exit=True).solve(
        packed
    )
    staged = np.concatenate(
        [
            np.array([sel.index, int(sel.found), sel.n_feasible], np.int32),
            np.asarray(sel.row, np.int32),
        ]
    )
    schedule = np.asarray(
        make_schedule_planner(union, horizon)(packed), np.int32
    )
    return {
        "selection": selection,
        "staged_selection": staged,
        "schedule": schedule,
    }


def jax_lane_answers(packed) -> dict:
    """The JAX package's per-lane union and repair results for
    ``packed``: feasible bool [C] and assignment int32 [C, K] of each."""
    from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu.solver.repair import plan_repair_jit

    union = with_repair(plan_ffd, 8)(packed)
    repair = plan_repair_jit(packed, rounds=8)
    return {
        "union_feasible": np.asarray(union.feasible, bool),
        "union_assignment": np.asarray(union.assignment, np.int32),
        "repair_feasible": np.asarray(repair.feasible, bool),
        "repair_assignment": np.asarray(repair.assignment, np.int32),
    }


def freeze(config_id, seed: int = 0) -> str:
    packed = pack_config(config_id, seed)
    answers = jax_answers(packed)
    if config_id == CONTENDED:
        answers.update(jax_lane_answers(packed))
    os.makedirs(DATA_DIR, exist_ok=True)
    path = frozen_path(config_id, seed)
    save_npz(
        path,
        packed,
        config_id=np.asarray(config_id),
        seed=np.int32(seed),
        **answers,
    )
    return path


def main(argv) -> int:
    for arg in argv or ["3"]:
        path = freeze(arg if arg == CONTENDED else int(arg))
        print(f"{path}: {os.path.getsize(path)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
