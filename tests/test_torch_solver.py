"""The PyTorch port's greedy solve and validation against the JAX package.

Same numpy-seeded inputs through the JAX function and the port's
counterpart on the CPU (``device="cpu"``); every output must be exactly
equal. Kernels B1/B2/B3 run here as their plain versions (the wrappers
take them for CPU tensors); the kernels themselves are checked on the
card by ``tests/test_torch_kernels.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS
from k8s_spot_rescheduler_tpu.models.tensors import PackedCluster
from k8s_spot_rescheduler_tpu.ops.pallas_ffd import plan_ffd_pallas
from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd_jit
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_oracle
from k8s_spot_rescheduler_tpu.solver.validate import (
    validate_assignment as jax_validate_assignment,
)
from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.models import tensors as ttensors
from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    first_true,
    or_reduce,
    plan_ffd,
)
from k8s_spot_rescheduler_tpu_torch.solver.validate import validate_assignment
from tests.test_solver import _pack_drain_case, _random_packed, _test_spot_pool
from tests.torch_port_fixtures import pack_config, pack_spec

torch.set_num_threads(1)


def _cpu(packed):
    return ttensors.to_device(packed, "cpu")


def _assert_same(want, got):
    np.testing.assert_array_equal(np.asarray(want.feasible), got.feasible.numpy())
    np.testing.assert_array_equal(
        np.asarray(want.assignment), got.assignment.numpy()
    )


def _small_config(config_id: int):
    spec = dataclasses.replace(
        CONFIGS[config_id], n_on_demand=10, n_spot=12, n_pods=150
    )
    return pack_spec(spec, 3)


# --- models/tensors -------------------------------------------------------


def test_to_device_round_trip_keeps_every_bit(tmp_path):
    packed = _random_packed(np.random.default_rng(5))
    packed = packed._replace(
        slot_aff=packed.slot_aff | np.uint32(1 << 31),
        spot_taints=packed.spot_taints | np.uint32(0xFFFF0000),
    )
    dev = _cpu(packed)
    assert dev.slot_tol.dtype == torch.int32
    assert dev.spot_aff.dtype == torch.int32
    back = ttensors.to_numpy(dev)
    path = str(tmp_path / "p.npz")
    ttensors.save_npz(path, back, answer=np.arange(3))
    loaded, extra = ttensors.load_npz(path)
    for f in PackedCluster._fields:
        for arr in (getattr(back, f), getattr(loaded, f)):
            assert arr.dtype == getattr(packed, f).dtype, f
            np.testing.assert_array_equal(arr, getattr(packed, f))
    np.testing.assert_array_equal(extra["answer"], np.arange(3))


def test_cuda_request_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA request is legitimate")
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttensors.to_device(_random_packed(np.random.default_rng(0)), "cuda")
    assert resolve_device("cpu").type == "cpu"


# --- helpers with torch-specific rules ------------------------------------


def test_first_true_takes_the_first_index_and_zero_when_none():
    mask = torch.tensor(
        [[False, True, True], [False, False, False], [True, False, True]]
    )
    assert first_true(mask).tolist() == [1, 0, 0]


@pytest.mark.parametrize("n", [0, 1, 2, 5, 8, 33])
def test_or_reduce_matches_numpy(n):
    rng = np.random.default_rng(n)
    words = rng.integers(0, 2**32, (3, n, 2), dtype=np.uint64).astype(np.uint32)
    got = or_reduce(torch.from_numpy(words.view(np.int32)), 1).numpy()
    want = (
        np.bitwise_or.reduce(words, axis=1)
        if n
        else np.zeros((3, 2), np.uint32)
    )
    np.testing.assert_array_equal(got.view(np.uint32), want)


def test_best_fit_ties_go_to_the_lowest_index():
    """Two spots with the same least slack: the earlier one wins, as
    the reference's argmin (and the kernel's (slack, index) election)."""
    W, A = 1, 2
    packed = PackedCluster(
        slot_req=np.array([[[3.0]]], np.float32),
        slot_valid=np.ones((1, 1), bool),
        slot_tol=np.zeros((1, 1, W), np.uint32),
        slot_aff=np.zeros((1, 1, A), np.uint32),
        cand_valid=np.ones((1,), bool),
        spot_free=np.array([[9.0], [5.0], [7.0], [5.0]], np.float32),
        spot_count=np.zeros((4,), np.int32),
        spot_max_pods=np.full((4,), 10, np.int32),
        spot_taints=np.zeros((4, W), np.uint32),
        spot_ok=np.ones((4,), bool),
        spot_aff=np.zeros((4, A), np.uint32),
    )
    got = plan_ffd(_cpu(packed), best_fit=True)
    assert got.assignment.tolist() == [[1]]
    _assert_same(plan_ffd_jit(packed, best_fit=True), got)


# --- plan_ffd (the plain version of B1/B2) --------------------------------


@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", range(24))
def test_plan_ffd_matches_oracle_randomized(seed, best_fit):
    packed = _random_packed(np.random.default_rng(seed))
    _assert_same(
        plan_oracle(packed, best_fit=best_fit),
        plan_ffd(_cpu(packed), best_fit=best_fit),
    )


@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_plan_ffd_matches_jax_jit(seed, best_fit):
    packed = _random_packed(np.random.default_rng(seed))
    _assert_same(
        plan_ffd_jit(packed, best_fit=best_fit),
        plan_ffd(_cpu(packed), best_fit=best_fit),
    )


@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", [0, 3])
def test_plan_ffd_matches_pallas_interpret(seed, best_fit):
    packed = _random_packed(np.random.default_rng(seed))
    want = plan_ffd_pallas(packed, interpret=True, best_fit=best_fit)
    _assert_same(want, plan_ffd(_cpu(packed), best_fit=best_fit))


@pytest.mark.parametrize(
    "pods", [[500, 300, 100, 100, 100], [500, 400, 100, 100, 100]]
)
def test_plan_ffd_on_the_drain_fixture(pods):
    packed, _ = _pack_drain_case(_test_spot_pool(), pods)
    for best_fit in (False, True):
        _assert_same(
            plan_ffd_jit(packed, best_fit=best_fit),
            ffd_kernels.plan_ffd_kernel(_cpu(packed), best_fit=best_fit),
        )


@pytest.mark.parametrize("config_id", [1, 2, 3, 4])
def test_plan_ffd_on_synthetic_packs(config_id):
    packed = (
        pack_config(config_id, 0) if config_id == 1 else _small_config(config_id)
    )
    for best_fit in (False, True):
        _assert_same(
            plan_ffd_jit(packed, best_fit=best_fit),
            plan_ffd(_cpu(packed), best_fit=best_fit),
        )


# --- B3's chunk loop (plain first-fit per chunk) ---------------------------


@pytest.mark.parametrize("chunk", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", range(6))
def test_chunked_first_fit_equals_unchunked(seed, chunk):
    packed = _random_packed(np.random.default_rng(100 + seed))
    before = dict(ffd_kernels.LAUNCHES)
    got = ffd_kernels.plan_ffd_chunked(_cpu(packed), chunk)
    assert ffd_kernels.LAUNCHES == before  # CPU tensors launch nothing
    _assert_same(plan_ffd_jit(packed), got)


def test_greedy_solver_routes_modes():
    packed = _cpu(_random_packed(np.random.default_rng(11)))
    chunked = ffd_kernels.greedy_solver(spot_chunk=2)
    plain = ffd_kernels.greedy_solver()
    for best_fit in (False, True):
        a = chunked(packed, best_fit=best_fit)
        b = plain(packed, best_fit=best_fit)
        assert torch.equal(a.feasible, b.feasible)
        assert torch.equal(a.assignment, b.assignment)


# --- validate_assignment ---------------------------------------------------


@pytest.mark.parametrize("seed", range(16))
def test_validate_matches_jax(seed):
    rng = np.random.default_rng(200 + seed)
    packed = _random_packed(rng)
    C, K, _ = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    # greedy rows (mostly valid) and random rows, out of bounds included
    greedy = np.asarray(plan_oracle(packed).assignment)
    noise = rng.integers(-1, S + 1, (C, K)).astype(np.int32)
    for assign in (greedy, noise, np.where(rng.random((C, K)) < 0.5, greedy, noise)):
        want = jax_validate_assignment(np, packed, assign)
        got = validate_assignment(_cpu(packed), torch.from_numpy(assign))
        np.testing.assert_array_equal(want, got.numpy())


def test_validate_stays_exact_above_2048():
    """Integral capacities far past TF32's 11 mantissa bits must sum
    exactly: lane 0 fills spot 0 to the unit, lane 1 overflows spot 1
    by one."""
    W, A = 1, 2
    req = np.array([[35001.0], [35000.0], [3.0]], np.float32)
    packed = PackedCluster(
        slot_req=np.stack([req, req]),
        slot_valid=np.ones((2, 3), bool),
        slot_tol=np.zeros((2, 3, W), np.uint32),
        slot_aff=np.zeros((2, 3, A), np.uint32),
        cand_valid=np.ones((2,), bool),
        spot_free=np.array([[70004.0], [70003.0]], np.float32),
        spot_count=np.zeros((2,), np.int32),
        spot_max_pods=np.full((2,), 10, np.int32),
        spot_taints=np.zeros((2, W), np.uint32),
        spot_ok=np.ones((2,), bool),
        spot_aff=np.zeros((2, A), np.uint32),
    )
    assign = np.array([[0, 0, 0], [1, 1, 1]], np.int32)
    got = validate_assignment(_cpu(packed), torch.from_numpy(assign))
    assert got.tolist() == [True, False]
    np.testing.assert_array_equal(
        jax_validate_assignment(np, packed, assign), got.numpy()
    )
