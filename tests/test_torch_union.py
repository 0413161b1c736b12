"""The PyTorch port's repair, union, selection, prefilter and drain
schedule against the JAX package, on the CPU with exact equality.

Inputs are made from numpy seeds (``tests/test_solver._random_packed``,
the repair fixtures, the synthetic and quality configs) and go through
the JAX function (or its numpy oracle, which the JAX tests pin
bit-identical to it) and the port's counterpart with ``device="cpu"``.
"""

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.bench.quality import pack_quality
from k8s_spot_rescheduler_tpu.io.synthetic import QUALITY_CONFIGS
from k8s_spot_rescheduler_tpu.solver.fallback import (
    with_repair as jax_with_repair,
)
from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd as jax_plan_ffd
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_union_oracle
from k8s_spot_rescheduler_tpu.solver.prefilter import (
    lane_maybe_feasible as jax_lane_maybe_feasible,
)
from k8s_spot_rescheduler_tpu.solver.repair import (
    plan_repair_jit,
    plan_repair_oracle,
)
from k8s_spot_rescheduler_tpu.solver.schedule import (
    commit_step_host as jax_commit_step_host,
    make_schedule_planner as jax_make_schedule_planner,
    plan_schedule_oracle,
)
from k8s_spot_rescheduler_tpu.solver.select import (
    make_fused_planner as jax_make_fused_planner,
)
from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import greedy_solver
from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
    with_best_fit_fallback,
    with_repair,
)
from k8s_spot_rescheduler_tpu_torch.solver.prefilter import lane_maybe_feasible
from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair
from k8s_spot_rescheduler_tpu_torch.solver.schedule import (
    commit_step_host,
    decode_schedule,
    schedule_matrix,
)
from k8s_spot_rescheduler_tpu_torch.solver.select import (
    StagedPlanner,
    decode_selection,
    make_fused_planner,
)
from tests.test_repair import (
    _affinity_swap_case,
    _rotation_coverage_case,
    _swap_case,
)
from tests.test_solver import _random_packed
from tests.torch_port_fixtures import pack_config

torch.set_num_threads(1)

QUALITY_SPEC = next(iter(QUALITY_CONFIGS.values()))


def _cpu(packed):
    return to_device(packed, "cpu")


def _assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want.feasible), got.feasible.numpy())
    np.testing.assert_array_equal(
        np.asarray(want.assignment), got.assignment.numpy()
    )


def _union():
    return with_repair(greedy_solver(), 8)


# --- plan_repair ------------------------------------------------------------


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("seed", range(16))
def test_plan_repair_matches_oracle_randomized(seed, chain):
    packed = _random_packed(np.random.default_rng(seed))
    _assert_same(
        plan_repair_oracle(packed, chain=chain),
        plan_repair(_cpu(packed), chain=chain),
    )


@pytest.mark.parametrize(
    "case", [_swap_case, _affinity_swap_case, _rotation_coverage_case]
)
def test_plan_repair_matches_jax_on_the_fixtures(case):
    packed = case()
    got = plan_repair(_cpu(packed))
    assert bool(got.feasible[0])
    _assert_same(plan_repair_jit(packed), got)
    _assert_same(plan_repair_oracle(packed), got)


def test_plan_repair_depth1_misses_the_chain_case():
    """chain=False is the depth-1 search: the off-diagonal chain lane
    the depth-2 search repairs stays infeasible, as in the reference."""
    packed = _rotation_coverage_case()
    got = plan_repair(_cpu(packed), chain=False)
    _assert_same(plan_repair_jit(packed, chain=False), got)
    assert not bool(got.feasible[0])


# --- the union and the selection ---------------------------------------------


@pytest.mark.parametrize("seed", range(16))
def test_union_matches_oracle_randomized(seed):
    packed = _random_packed(np.random.default_rng(300 + seed))
    _assert_same(
        plan_union_oracle(packed, repair_rounds=8), _union()(_cpu(packed))
    )
    _assert_same(
        plan_union_oracle(packed, repair_rounds=0),
        with_best_fit_fallback(greedy_solver())(_cpu(packed)),
    )


@pytest.mark.parametrize("source", ["config1", "quality", "swap"])
def test_selection_matches_jax_fused_planner(source):
    packed = {
        "config1": lambda: pack_config(1, 0),
        "quality": lambda: pack_quality(QUALITY_SPEC, 0),
        "swap": _swap_case,
    }[source]()
    want = np.asarray(
        jax_make_fused_planner(jax_with_repair(jax_plan_ffd, 8))(packed)
    )
    got = make_fused_planner(_union())(_cpu(packed))
    np.testing.assert_array_equal(want, got.numpy())
    sel = decode_selection(got)
    assert (sel.index, sel.found, sel.n_feasible) == tuple(
        int(v) for v in want[:3]
    )


@pytest.mark.parametrize("early_exit", [True, False])
@pytest.mark.parametrize("chunk_lanes", [1, 2, 64])
def test_staged_selection_matches_unstaged(chunk_lanes, early_exit):
    packed = _cpu(pack_quality(QUALITY_SPEC, 1))
    fused = decode_selection(make_fused_planner(_union())(packed))
    sel, stats = StagedPlanner(
        _union(), chunk_lanes=chunk_lanes, early_exit=early_exit
    ).solve(packed)
    assert (sel.index, sel.found) == (fused.index, fused.found)
    np.testing.assert_array_equal(sel.row, fused.row)
    if stats.count_truncated:
        assert early_exit and sel.n_feasible <= fused.n_feasible
    else:
        assert sel.n_feasible == fused.n_feasible


@pytest.mark.parametrize("seed", range(6))
def test_prefilter_matches_jax(seed):
    packed = _random_packed(np.random.default_rng(400 + seed))
    np.testing.assert_array_equal(
        np.asarray(jax_lane_maybe_feasible(packed)),
        lane_maybe_feasible(_cpu(packed)).numpy(),
    )


# --- the drain schedule -------------------------------------------------------


@pytest.mark.parametrize("seed", range(12))
def test_schedule_matches_oracle_randomized(seed):
    packed = _random_packed(np.random.default_rng(500 + seed))
    want = plan_schedule_oracle(packed, 4, repair_rounds=8)
    got = schedule_matrix(_union(), _cpu(packed), 4).numpy()
    np.testing.assert_array_equal(want, got)


def test_schedule_matches_jax_program_with_its_minus_one_tail():
    packed = pack_quality(QUALITY_SPEC, 0)
    horizon = 24
    want = np.asarray(
        jax_make_schedule_planner(jax_with_repair(jax_plan_ffd, 8), horizon)(
            packed
        )
    )
    got = schedule_matrix(_union(), _cpu(packed), horizon).numpy()
    np.testing.assert_array_equal(want, got)
    steps = decode_schedule(got)
    # the terminal found=0 probe, then untouched -1 rows
    assert len(steps) < horizon - 1
    assert got[len(steps), 1] == 0
    assert (got[len(steps) + 1:] == -1).all()


@pytest.mark.parametrize("seed", range(6))
def test_commit_step_host_matches_jax(seed):
    packed = _random_packed(np.random.default_rng(600 + seed))
    res = plan_union_oracle(packed, repair_rounds=8)
    feasible = np.asarray(res.feasible)
    idx = int(np.argmax(feasible))
    row = np.asarray(res.assignment[idx], np.int32)
    want = jax_commit_step_host(packed, idx, row)
    got = commit_step_host(packed, idx, row)
    for f in want._fields:
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
