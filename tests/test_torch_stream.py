"""The port's carry layouts, memory ladder and streamed greedy passes
against the JAX package, on the CPU with exact equality.

Inputs are made from numpy seeds (``tests/test_solver._random_packed``,
the chunk-boundary and saturation packs of ``tests/test_carry_stream``,
the frozen config-4 pack) and go through the JAX function (or its numpy
oracle) and the port's counterpart on CPU tensors. Every value compared
is an integer or an integral f32, so the tolerance is exact equality.
"""

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.hot_programs import MAX_SHAPES
from k8s_spot_rescheduler_tpu.models.tensors import (
    PackedCluster as JaxPackedCluster,
)
from k8s_spot_rescheduler_tpu.ops.pallas_ffd import plan_stream_bf_pallas
from k8s_spot_rescheduler_tpu.solver import carry as jcarry
from k8s_spot_rescheduler_tpu.solver import memory as jmemory
from k8s_spot_rescheduler_tpu.solver.ffd import (
    plan_ffd as jax_plan_ffd,
    plan_ffd_streamed as jax_plan_ffd_streamed,
)
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_oracle
from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz, to_device
from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels
from k8s_spot_rescheduler_tpu_torch.solver import carry as tcarry
from k8s_spot_rescheduler_tpu_torch.solver import memory as tmemory
from k8s_spot_rescheduler_tpu_torch.testing import (
    STRESS_LAYOUTS,
    overlay_stress_packs,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    plan_ffd,
    plan_ffd_streamed,
)
from tests.test_carry_stream import (
    CHUNK_COUNTS,
    _edge_pack,
    _leftover_case,
)
from tests.test_solver import _pack_drain_case, _random_packed, _test_spot_pool
from tests.torch_port_fixtures import frozen_path

torch.set_num_threads(1)


def _cpu(packed):
    return to_device(packed, "cpu")


def _assert_same(want, got, note=""):
    np.testing.assert_array_equal(
        np.asarray(want.feasible), got.feasible.numpy(), err_msg=note
    )
    np.testing.assert_array_equal(
        np.asarray(want.assignment), got.assignment.numpy(), err_msg=note
    )


def _layouts(packed):
    """The wide layout and the pack's guarded one, in both packages."""
    lay = jcarry.carry_layout(packed)
    return [
        (jcarry.WIDE_LAYOUT, tcarry.WIDE_LAYOUT),
        (lay, tcarry.CarryLayout(*lay)),
    ]


# --- solver/carry --------------------------------------------------------------


def _saturation_packs():
    """The layout guard's edges (tests/test_carry_stream): consumed sums
    at and one past int16 and uint16, K at and past int8, the highest
    affinity bit at uint8, uint16 and past."""
    at_i16 = _edge_pack(4681.0, 7, 40000.0)  # 7*4681 = 32767
    k127 = _edge_pack(0.0, 127, 1.0)

    def with_bit(bit):
        aff = np.zeros((1, 2, 1), np.uint32)
        aff[0, 0, 0] = np.uint32(1) << bit
        return _edge_pack(1.0, 2, 10.0)._replace(slot_aff=aff)

    return {
        "at_int16": at_i16,
        "past_int16": _edge_pack(4682.0, 7, 40000.0),
        "at_uint16": _edge_pack(13107.0, 5, 70000.0),
        "past_uint16": _edge_pack(13108.0, 5, 70000.0),
        "k127": k127,
        "k128": _edge_pack(0.0, 128, 1.0),
        "bit7": with_bit(7),
        "bit15": with_bit(15),
        "bit16": with_bit(16),
        "bit31": with_bit(31),
    }


SATURATION = _saturation_packs()


@pytest.mark.parametrize("name", sorted(SATURATION))
def test_carry_layout_matches_jax_at_the_saturation_edges(name):
    packed = SATURATION[name]
    want = tuple(jcarry.carry_layout(packed))
    assert tuple(tcarry.carry_layout(packed)) == want
    assert tuple(tcarry.carry_layout(_cpu(packed))) == want


@pytest.mark.parametrize("seed", range(8))
def test_carry_layout_matches_jax_randomized(seed):
    packed = _random_packed(np.random.default_rng(seed))
    want = tuple(jcarry.carry_layout(packed))
    assert tuple(tcarry.carry_layout(packed)) == want
    assert tuple(tcarry.carry_layout(_cpu(packed))) == want


def test_carry_layout_reads_config4_words_unsigned():
    """Config 4's affinity words have bits past 0xFFFF: the port holds
    them as int32 bits, whose OR is negative, and must still widen aff
    to uint32 (a signed reading would pick uint8)."""
    host, _ = load_npz(frozen_path(4))
    dev = _cpu(host)
    assert int(np.bitwise_or.reduce(dev.slot_aff.numpy(), axis=None)) < 0
    want = tuple(jcarry.carry_layout(host))
    assert want[2] == "uint32"
    assert tuple(tcarry.carry_layout(host)) == want
    assert tuple(tcarry.carry_layout(dev)) == want


@pytest.mark.parametrize(
    "layout",
    [
        ("float32", "int32", "uint32"),
        ("int16", "int8", "uint16"),
        ("int16", "int8", "uint8"),
        ("uint16", "int16", "uint32"),
        ("float32", "int8", "uint8"),
    ],
)
def test_plane_bytes_and_narrow_flag_match_jax(layout):
    j, t = jcarry.CarryLayout(*layout), tcarry.CarryLayout(*layout)
    for R, A in ((1, 1), (2, 2), (4, 2), (4, 3)):
        assert tcarry.plane_bytes(t, R, A) == jcarry.plane_bytes(j, R, A)
    assert tcarry.is_narrow(t) == jcarry.is_narrow(j)
    assert tuple(tcarry.NARROW_LAYOUT) == tuple(jcarry.NARROW_LAYOUT)
    assert tuple(tcarry.WIDE_LAYOUT) == tuple(jcarry.WIDE_LAYOUT)


def test_torch_dtypes_hold_every_plane_exactly():
    """uint16 planes widen to int32 (no uint16 add on the CPU) and
    uint32 words are int32 bits; the rest keep their own dtype."""
    assert tcarry.torch_dtype("uint16") == torch.int32
    assert tcarry.torch_dtype("uint32") == torch.int32
    for name in ("int8", "uint8", "int16", "int32", "float32"):
        assert tcarry.torch_dtype(name) == getattr(torch, name)


# --- solver/memory -------------------------------------------------------------


def _grid_shapes():
    shapes = [
        (2560, 32, 2560, 4, 1, 2),  # config 3
        (512, 8, 1152, 2, 17, 2),  # the contended problem
        (6400, 32, 51200, 4, 2, 2),
        (2560 * 16, 32, 2560 * 16, 4, 2, 2),  # 16x
        (MAX_SHAPES.C, MAX_SHAPES.K, MAX_SHAPES.S, MAX_SHAPES.R,
         MAX_SHAPES.W, MAX_SHAPES.A),  # 20x
    ]
    return shapes


@pytest.mark.parametrize("n_devices", [1, 2, 8])
@pytest.mark.parametrize("shape", _grid_shapes(), ids=lambda s: f"C{s[0]}S{s[2]}")
def test_pick_tier_matches_jax(shape, n_devices):
    budget = int(jmemory.DEFAULT_HBM_BYTES * jmemory.BUDGET_FRACTION)
    R, A = shape[3], shape[5]
    for budget_bytes in (budget, budget // 8, 80 * 1024**3):
        for wants_repair in (True, False):
            for layout in (
                jcarry.NARROW_LAYOUT,
                jcarry.CarryLayout("float32", "int8", "uint8"),
            ):
                kw = dict(
                    n_devices=n_devices,
                    budget_bytes=budget_bytes,
                    wants_repair=wants_repair,
                    carry_plane_bytes=jcarry.plane_bytes(layout, R, A),
                )
                want = jmemory.pick_tier(*shape, **kw)
                assert tmemory.pick_tier(*shape, **kw) == tuple(want)
            assert tmemory.pick_repair_chunks(
                *shape, budget_bytes
            ) == jmemory.pick_repair_chunks(*shape, budget_bytes)
            assert tmemory.pick_carry_chunks(
                *shape, budget_bytes, carry_plane_bytes=11
            ) == jmemory.pick_carry_chunks(
                *shape, budget_bytes, carry_plane_bytes=11
            )


def test_pick_tier_20x_lands_on_the_carry_tier_with_repair_live():
    """The 20x shapes over 8 devices at the JAX package's default
    budget: the carry-streamed tier with repair live, as the JAX
    package decides."""
    budget = int(tmemory.DEFAULT_HBM_BYTES * tmemory.BUDGET_FRACTION)
    s = MAX_SHAPES
    tier = tmemory.pick_tier(
        s.C, s.K, s.S, s.R, s.W, s.A,
        n_devices=8, budget_bytes=budget, wants_repair=True,
        carry_plane_bytes=lambda: tcarry.plane_bytes(
            tcarry.NARROW_LAYOUT, s.R, s.A
        ),
    )
    assert tier.kind == "cand-carry" and tier.carry_chunks > 1
    assert not tier.repair_unavailable


@pytest.mark.parametrize("carry_chunks", [0, 1, 4])
@pytest.mark.parametrize("repair_spot_chunks", [0, 1, 4])
def test_estimate_breakdown_matches_jax(repair_spot_chunks, carry_chunks):
    for shape in _grid_shapes():
        kw = dict(
            repair_spot_chunks=repair_spot_chunks,
            carry_chunks=carry_chunks,
        )
        assert tmemory.estimate_union_hbm_breakdown(
            *shape, **kw
        ) == jmemory.estimate_union_hbm_breakdown(*shape, **kw)


def test_device_budget_without_a_card_is_the_default():
    assert tmemory.device_hbm_budget() == int(
        jmemory.DEFAULT_HBM_BYTES * jmemory.BUDGET_FRACTION
    )
    assert tmemory.device_hbm_budget("cpu") == tmemory.device_hbm_budget()
    packed = _random_packed(np.random.default_rng(1))
    assert tmemory.packed_shapes(_cpu(packed)) == jmemory.packed_shapes(packed)


# --- plan_ffd with a layout and plan_ffd_streamed -------------------------------


@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_plan_ffd_with_the_guarded_layout_matches_jax(seed, best_fit):
    packed = _random_packed(np.random.default_rng(seed))
    jlay, tlay = _layouts(packed)[1]
    _assert_same(
        jax_plan_ffd(packed, best_fit=best_fit, layout=jlay),
        plan_ffd(_cpu(packed), best_fit=best_fit, layout=tlay),
    )


@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", range(8))
def test_streamed_matches_jax_and_the_oracle(seed, best_fit):
    packed = _random_packed(np.random.default_rng(100 * best_fit + seed))
    want = plan_oracle(packed, best_fit=best_fit)
    for jlay, tlay in _layouts(packed):
        for n in CHUNK_COUNTS:
            got = plan_ffd_streamed(
                _cpu(packed), carry_chunks=n, layout=tlay, best_fit=best_fit
            )
            note = f"chunks={n} layout={tlay}"
            _assert_same(want, got, note)
            if jlay != jcarry.WIDE_LAYOUT:
                _assert_same(
                    jax_plan_ffd_streamed(
                        packed, carry_chunks=n, layout=jlay, best_fit=best_fit
                    ),
                    got,
                    note,
                )


def _edge_cases():
    cases = {
        "leftover": _leftover_case(),
        "edge_100x3": _edge_pack(100.0, 3, 100.0),
        "edge_1x1": _edge_pack(1.0, 1, 3.0),
    }
    for i, pods in enumerate(
        ([500, 300, 100, 100, 100], [500, 400, 100, 100, 100])
    ):
        cases[f"drain{i}"] = _pack_drain_case(_test_spot_pool(), pods)[0]
    cases.update(SATURATION)
    return cases


EDGE_CASES = _edge_cases()


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_streamed_on_the_edge_packs(name):
    """Leftovers straddling chunk splits, saturating residuals, ties to
    the earlier index, at chunk counts that put a boundary inside the
    probe order; the kernel wrappers take the same plain versions on
    CPU tensors and launch nothing."""
    packed = EDGE_CASES[name]
    lay = tcarry.carry_layout(packed)
    dev = _cpu(packed)
    before = dict(ffd_kernels.LAUNCHES)
    for best_fit in (False, True):
        want = plan_oracle(packed, best_fit=best_fit)
        for n in (1, 2, 3, 4):
            _assert_same(
                want,
                plan_ffd_streamed(
                    dev, carry_chunks=n, layout=lay, best_fit=best_fit
                ),
                f"n={n} best_fit={best_fit}",
            )
            wrapper = (
                ffd_kernels.plan_stream_bf_kernel
                if best_fit
                else ffd_kernels.plan_stream_ff_kernel
            )
            _assert_same(want, wrapper(dev, carry_chunks=n, layout=lay))
    assert ffd_kernels.LAUNCHES == before


STRESS = overlay_stress_packs(0)


@pytest.mark.parametrize("name", list(STRESS))
def test_streamed_best_fit_matches_the_pallas_stream_kernel_on_stress_packs(
    name,
):
    """The plain version of B4 (the streamed best-fit) on each pack that
    stresses the overlay, at its own carry layout, against the JAX
    package's Pallas stream kernel in interpret mode: used at the int16
    and uint16 edges, dcount at int8's guard, affinity bits 7, 15 and 31,
    K distinct spots a lane; the B4 wrapper takes the same plain version
    on CPU tensors."""
    host = JaxPackedCluster(*STRESS[name])
    lay = jcarry.carry_layout(host)
    if name in STRESS_LAYOUTS:
        assert tuple(lay) == STRESS_LAYOUTS[name]
    tlay = tcarry.CarryLayout(*lay)
    dev = _cpu(STRESS[name])
    for n in (1, 3):
        want = plan_stream_bf_pallas(
            host, carry_chunks=n, layout=lay, interpret=True
        )
        _assert_same(
            want,
            plan_ffd_streamed(dev, carry_chunks=n, layout=tlay, best_fit=True),
            f"n={n}",
        )
        _assert_same(
            want,
            ffd_kernels.plan_stream_bf_kernel(dev, carry_chunks=n, layout=tlay),
        )
