"""The port's spot-chunked repair, carry-streamed union and the
selection and schedule over it, against the JAX package on the CPU with
exact equality.

The JAX side runs as its own tests run it on the CPU: the fused stream
kernel B4 stands behind ``with_repair_streamed(use_pallas=True)`` in
Pallas interpret mode. The port's kernel flag (``use_kernel``) takes
the plain versions on CPU tensors, so the same union runs here.
"""

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.bench.quality import pack_quality
from k8s_spot_rescheduler_tpu.io.synthetic import QUALITY_CONFIGS
from k8s_spot_rescheduler_tpu.solver import carry as jcarry
from k8s_spot_rescheduler_tpu.solver.fallback import (
    union_program as jax_union_program,
    with_repair_streamed as jax_with_repair_streamed,
)
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_union_oracle
from k8s_spot_rescheduler_tpu.solver.repair import (
    plan_repair_chunked as jax_plan_repair_chunked,
    plan_repair_oracle,
)
from k8s_spot_rescheduler_tpu.solver.schedule import (
    make_schedule_planner as jax_make_schedule_planner,
    plan_schedule_oracle,
)
from k8s_spot_rescheduler_tpu.solver.select import (
    make_fused_planner as jax_make_fused_planner,
)
from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels
from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    WIDE_LAYOUT,
    CarryLayout,
    carry_layout,
)
from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
    union_program,
    with_repair,
    with_repair_streamed,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd
from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair_chunked
from k8s_spot_rescheduler_tpu_torch.solver.schedule import schedule_matrix
from k8s_spot_rescheduler_tpu_torch.solver.select import (
    StagedPlanner,
    decode_selection,
    make_fused_planner,
)
from tests.test_carry_stream import CHUNK_COUNTS
from tests.test_repair import _affinity_swap_case, _rotation_coverage_case
from tests.test_repair_chunked import _swap_case
from tests.test_solver import _random_packed

torch.set_num_threads(1)

QUALITY_SPEC = next(iter(QUALITY_CONFIGS.values()))


def _cpu(packed):
    return to_device(packed, "cpu")


def _assert_same(want, got, note=""):
    np.testing.assert_array_equal(
        np.asarray(want.feasible), got.feasible.numpy(), err_msg=note
    )
    np.testing.assert_array_equal(
        np.asarray(want.assignment), got.assignment.numpy(), err_msg=note
    )


# --- plan_repair_chunked ---------------------------------------------------------


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("seed", range(8))
def test_repair_chunked_matches_the_oracle(seed, chain):
    packed = _random_packed(np.random.default_rng(300 + seed))
    want = plan_repair_oracle(packed, rounds=6, chain=chain)
    dev = _cpu(packed)
    for layout in (WIDE_LAYOUT, carry_layout(packed)):
        for n in CHUNK_COUNTS:
            _assert_same(
                want,
                plan_repair_chunked(
                    dev, rounds=6, chain=chain, spot_chunks=n, layout=layout
                ),
                f"chunks={n} layout={layout}",
            )


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize(
    "case", [_swap_case, _affinity_swap_case, _rotation_coverage_case]
)
def test_repair_chunked_matches_jax_on_the_fixtures(case, chain):
    """The repair fixtures, where the direct move, the exact affinity
    ejection and the depth-2 chain each decide a lane."""
    packed = case()
    lay = jcarry.carry_layout(packed)
    for n in (2, 3):
        want = jax_plan_repair_chunked(
            packed, rounds=8, chain=chain, spot_chunks=n, layout=lay
        )
        got = plan_repair_chunked(
            _cpu(packed), rounds=8, chain=chain, spot_chunks=n,
            layout=CarryLayout(*lay),
        )
        _assert_same(want, got, f"chunks={n}")
        _assert_same(plan_repair_oracle(packed, rounds=8, chain=chain), got)


@pytest.mark.parametrize("seed", range(2))
def test_repair_chunked_matches_jax_randomized(seed):
    packed = _random_packed(np.random.default_rng(310 + seed))
    lay = jcarry.carry_layout(packed)
    want = jax_plan_repair_chunked(packed, rounds=6, spot_chunks=3, layout=lay)
    _assert_same(
        want,
        plan_repair_chunked(
            _cpu(packed), rounds=6, spot_chunks=3, layout=CarryLayout(*lay)
        ),
    )


# --- the carry-streamed union ------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_streamed_union_matches_the_oracle_union(seed):
    packed = _random_packed(np.random.default_rng(200 + seed))
    want = plan_union_oracle(packed, repair_rounds=8)
    dev = _cpu(packed)
    lay = carry_layout(packed)
    for n in CHUNK_COUNTS:
        for use_kernel in (False, True):
            got = with_repair_streamed(8, n, lay, use_kernel=use_kernel)(dev)
            _assert_same(want, got, f"chunks={n} use_kernel={use_kernel}")
    _assert_same(want, with_repair(plan_ffd, 8, spot_chunks=3)(dev))


@pytest.mark.parametrize("seed", [0, 5, 9])
def test_union_program_matches_jax_with_the_pallas_stream_kernel(seed):
    """The kernel flag on, against the JAX union with B4 in interpret
    mode: the composition the carry tier dispatches."""
    packed = _random_packed(np.random.default_rng(seed))
    lay = jcarry.carry_layout(packed)
    want = jax_with_repair_streamed(2, 3, lay, use_pallas=True)(packed)
    before = dict(ffd_kernels.LAUNCHES)
    got = union_program(
        2, carry_chunks=3, carry_layout=CarryLayout(*lay), use_kernel=True
    )(_cpu(packed))
    assert ffd_kernels.LAUNCHES == before  # CPU tensors launch nothing
    _assert_same(want, got)


@pytest.mark.parametrize(
    "flags",
    [
        dict(rounds=8),
        dict(rounds=0),
        dict(rounds=8, best_fit_fallback=False),
        dict(rounds=8, repair_spot_chunks=2),
        dict(rounds=8, carry_chunks=2),
    ],
    ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()),
)
def test_union_program_ladder_matches_jax(flags):
    """Every rung of the ladder on a repair-demanding fixture."""
    packed = _swap_case()
    flags = dict(flags)
    rounds = flags.pop("rounds")
    want = jax_union_program(rounds, **flags)(packed)
    for use_kernel in (False, True):
        _assert_same(
            want, union_program(rounds, use_kernel=use_kernel, **flags)(_cpu(packed))
        )


# --- selection and schedule over the streamed union --------------------------------


def test_streamed_selection_and_schedule_match_jax():
    """The quality pack (repair decides lanes): the fused and staged
    selections and a 6-step schedule over the streamed union, kernel
    flag on, equal the JAX package's over its own streamed union."""
    packed = pack_quality(QUALITY_SPEC, 0)
    lay = jcarry.carry_layout(packed)
    dev = _cpu(packed)
    for n in (2, 4):
        jax_union = jax_union_program(
            8, carry_chunks=n, carry_layout=lay, use_pallas=True
        )
        union = union_program(
            8, carry_chunks=n, carry_layout=carry_layout(dev), use_kernel=True
        )
        want = np.asarray(jax_make_fused_planner(jax_union)(packed))
        got = make_fused_planner(union)(dev).numpy()
        np.testing.assert_array_equal(want, got)
        sel, _ = StagedPlanner(union, chunk_lanes=4, early_exit=False).solve(dev)
        fused = decode_selection(torch.from_numpy(got))
        assert (sel.index, sel.found, sel.n_feasible) == (
            fused.index, fused.found, fused.n_feasible
        )
        np.testing.assert_array_equal(sel.row, fused.row)
        schedule = schedule_matrix(union, dev, 6).numpy()
        np.testing.assert_array_equal(
            plan_schedule_oracle(packed, 6, repair_rounds=8), schedule
        )
        if n == 2:
            np.testing.assert_array_equal(
                np.asarray(jax_make_schedule_planner(jax_union, 6)(packed)),
                schedule,
            )
