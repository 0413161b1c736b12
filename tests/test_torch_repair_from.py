"""Repair split at its partial pass, the union around kernel B5, and the
repair gate's count, on the CPU.

- ``repair_from`` from the partial pass's carry and assignment,
  validated, equals ``plan_repair`` and the JAX package's
  ``plan_repair``, with and without the chain, on packs where direct
  and chain moves both fire and on packs with invalid lanes;
- the JAX package's partial pass (its ``_partial_scan_step`` scan) is
  best-fit's raw, unmasked placements (``greedy_pass(best_fit=True)``,
  whose placements ``ffd_raw`` returns), which the port's
  ``plan_repair`` and B5 take for it;
- ``with_repair`` on CPU tensors still equals the numpy oracle's union
  (``plan_union_oracle(repair_rounds=8)``);
- the repair gate is one ``device_sync`` a union solve, and
  ``repair_lanes_total`` rises by the count of the lanes the greedy
  passes left unproven, which the ``union.repair`` span carries as its
  ``lanes`` attribute.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.models.tensors import (
    PackedCluster as JaxPackedCluster,
)
from k8s_spot_rescheduler_tpu.solver import repair as jax_repair
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_union_oracle
from k8s_spot_rescheduler_tpu.solver.repair import plan_repair_jit
from k8s_spot_rescheduler_tpu_torch.metrics import registry
from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import greedy_solver
from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
    union_program,
    with_repair,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    ffd_raw,
    greedy_pass,
    plan_ffd,
)
from k8s_spot_rescheduler_tpu_torch.solver.repair import (
    plan_repair,
    repair_from,
    validated,
)
from k8s_spot_rescheduler_tpu_torch.testing import REPAIR_SHAPES, repair_pack
from k8s_spot_rescheduler_tpu_torch.utils import tracing
from tests.test_solver import _random_packed

torch.set_num_threads(1)

SEEDS = range(4)


def _pack(source: str, seed: int):
    """(host pack, CPU pack): a ``repair_pack`` of one of its shapes, or
    ``tests/test_solver._random_packed``."""
    if source == "random":
        host = _random_packed(np.random.default_rng(500 + seed))
    else:
        host = repair_pack(seed, source)
    return host, to_device(host, "cpu")


def _same(want, got):
    np.testing.assert_array_equal(np.asarray(want.feasible),
                                  got.feasible.numpy())
    np.testing.assert_array_equal(np.asarray(want.assignment),
                                  got.assignment.numpy())


def _partial(packed):
    """The partial pass: best-fit's (carry, raw placements)."""
    return greedy_pass(packed, True)


def _jax_partial(host) -> np.ndarray:
    """int32 [C, K]: the JAX package's partial pass, the scan of its
    ``_partial_scan_step`` as its ``plan_repair`` runs it."""
    packed = JaxPackedCluster(*host)
    C, K, R = host.slot_req.shape
    S, A = host.spot_aff.shape
    carry = jax_repair._zero_carry(jax_repair.WIDE_LAYOUT, C, R, A, S,
                                   jnp.asarray(packed.cand_valid))
    _, chosen = jax.lax.scan(
        functools.partial(jax_repair._partial_scan_step,
                          jax_repair._spot_statics(packed)),
        carry, jax_repair._slot_stream(packed))
    return np.asarray(chosen).T.astype(np.int32)


def _unproven(packed):
    ff = plan_ffd(packed)
    bf = plan_ffd(packed, best_fit=True)
    return packed.cand_valid & ~(ff.feasible | bf.feasible)


@pytest.mark.parametrize("chain", [True, False])
@pytest.mark.parametrize("source", [*REPAIR_SHAPES, "random"])
@pytest.mark.parametrize("seed", SEEDS)
def test_repair_from_the_partial_pass_is_plan_repair(seed, source, chain):
    host, packed = _pack(source, seed)
    got = validated(packed, repair_from(packed, _partial(packed),
                                        chain=chain))
    _same(plan_repair(packed, chain=chain), got)
    _same(plan_repair_jit(JaxPackedCluster(*host), chain=chain), got)


@pytest.mark.parametrize("shape", list(REPAIR_SHAPES))
def test_the_repair_packs_fire_direct_and_chain_moves(shape):
    """Over the seeds, repair moves pods on unproven lanes (the depth-1
    search changes the partial assignment), the chain moves more (the
    depth-2 search differs from the depth-1 one) and proves lanes, and
    some lanes are invalid: the kernel tests on these packs see every
    branch of the rounds."""
    moved = chained = proved = invalid = 0
    for seed in SEEDS:
        packed = repair_pack(seed, shape)
        packed = to_device(packed, "cpu")
        unproven = _unproven(packed)
        a0 = _partial(packed)
        direct = repair_from(packed, a0, chain=False)
        chain = repair_from(packed, a0)
        moved += int(((direct != a0[1]).any(dim=1) & unproven).sum())
        chained += int(((chain != direct).any(dim=1) & unproven).sum())
        proved += int((validated(packed, chain).feasible & unproven).sum())
        invalid += int((~packed.cand_valid).sum())
    assert moved and chained and proved and invalid


@pytest.mark.parametrize("source", [*REPAIR_SHAPES, "random"])
@pytest.mark.parametrize("seed", SEEDS)
def test_the_partial_pass_is_best_fits_raw_placements(seed, source):
    host, packed = _pack(source, seed)
    placed = _partial(packed)[1]
    np.testing.assert_array_equal(_jax_partial(host), placed.numpy())
    np.testing.assert_array_equal(placed.numpy(),
                                  ffd_raw(packed, True)[1].numpy())


@pytest.mark.parametrize("source", [*REPAIR_SHAPES, "random"])
@pytest.mark.parametrize("seed", SEEDS)
def test_with_repair_on_cpu_tensors_is_the_oracles_union(seed, source):
    host, packed = _pack(source, seed)
    _same(plan_union_oracle(host, repair_rounds=8),
          with_repair(greedy_solver(), 8)(packed))


def _union(kind: str):
    if kind == "streamed":
        return union_program(8, carry_chunks=2, use_kernel=True)
    return with_repair(greedy_solver(), 8)


@pytest.mark.parametrize("kind", ["unchunked", "streamed"])
@pytest.mark.parametrize("shape", list(REPAIR_SHAPES))
def test_the_repair_gate_is_one_read_and_counts_the_lanes(shape, kind):
    packed = to_device(repair_pack(1, shape), "cpu")
    lanes = int(_unproven(packed).sum())
    assert lanes > 0
    union = _union(kind)
    before = registry.host_sync_snapshot()["by_site"].get("repair-gate", 0.0)
    count0 = registry.repair_lanes.value()
    with tracing.tick_trace(enabled=True) as trace:
        union(packed)
    after = registry.host_sync_snapshot()["by_site"]["repair-gate"]
    assert after - before == 1
    assert registry.repair_lanes.value() - count0 == lanes
    (span,) = trace.find("union.repair")
    assert span.attrs["lanes"] == lanes
    # a CPU pack takes the plain version: B5 has no CPU mode
    assert not trace.find("repair.kernel")
    assert len(trace.find("repair.rounds")) == 1


def test_no_repair_where_greedy_proves_every_lane():
    """Every valid lane proven: the gate still reads once, the count
    does not move and no repair span opens."""
    packed = to_device(repair_pack(1), "cpu")
    packed = packed._replace(cand_valid=packed.cand_valid & ~_unproven(packed))
    before = registry.host_sync_snapshot()["by_site"].get("repair-gate", 0.0)
    count0 = registry.repair_lanes.value()
    with tracing.tick_trace(enabled=True) as trace:
        with_repair(greedy_solver(), 8)(packed)
    assert registry.host_sync_snapshot()["by_site"]["repair-gate"] == (
        before + 1)
    assert registry.repair_lanes.value() == count0
    assert not trace.find("union.repair")
