"""The port's tenant mesh on the CPU against the JAX package's: the
batched tenant program split over ``[torch.device("cpu")] * n`` (one
contiguous tenant block a device, kernels B1t/B2t taking their plain
versions), its carry tier, and the planner service's tenant-axis
padding and batches over a 4-device mesh. The JAX side runs on the 8
virtual CPU devices ``tests/conftest.py`` forces. Every comparison is
exact."""

from __future__ import annotations

import functools

import jax
import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.models.tensors import PackedCluster as JPacked
from k8s_spot_rescheduler_tpu.parallel import mesh as jmesh
from k8s_spot_rescheduler_tpu.parallel import tenant_batch as jax_tb
from k8s_spot_rescheduler_tpu.service import server as jax_server
from k8s_spot_rescheduler_tpu.solver.carry import NARROW_LAYOUT, carry_layout
from k8s_spot_rescheduler_tpu.utils.clock import FakeClock as JFakeClock
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as JConfig,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    to_device,
)
from k8s_spot_rescheduler_tpu_torch.parallel import tenant_batch
from k8s_spot_rescheduler_tpu_torch.parallel.mesh import make_tenant_mesh
from k8s_spot_rescheduler_tpu_torch.service import buckets
from k8s_spot_rescheduler_tpu_torch.service.server import PlannerService
from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.test_repair import _affinity_swap_case, _rotation_coverage_case

torch.set_num_threads(1)

CPU = [torch.device("cpu")] * 8


@functools.lru_cache(maxsize=None)
def _tenants():
    """8 host problems of one bucket: the two contended pools greedy
    cannot prove (repair runs) and six seeded random packs whose
    affinity words fit 16 bits (so NARROW_LAYOUT is exact for all)."""
    rng = np.random.default_rng(5)
    packs = [PackedCluster(*_affinity_swap_case()),
             PackedCluster(*_rotation_coverage_case())]
    for _ in range(6):
        p = testing.random_pack(rng, 6, 5, 7, 1)
        packs.append(p._replace(
            slot_aff=testing.random_bits(rng, p.slot_aff.shape, top=16)))
    for p in packs:
        lay = carry_layout(JPacked(*p))
        assert all(np.dtype(getattr(lay, f)).itemsize
                   <= np.dtype(getattr(NARROW_LAYOUT, f)).itemsize
                   for f in lay._fields), lay
    dims = np.max([buckets.bucket_for(p) for p in packs], axis=0)
    b = buckets.Bucket(*(int(d) for d in dims))
    return b, [buckets.pad_to_bucket(p, b) for p in packs]


def _stack(T: int):
    b, packs = _tenants()
    return buckets.stack_bucket(packs[:T], b)


@functools.lru_cache(maxsize=None)
def _jax_rows(T: int, carry_chunks: int = 0, n: int = 0) -> np.ndarray:
    """The JAX batch's rows for the first T tenants: its one-device
    ``vmap`` program, or over a tenant mesh of ``n`` devices."""
    mesh = jmesh.make_tenant_mesh(jax.devices()[:n]) if n else None
    return np.asarray(jax_tb.make_tenant_batch_planner(
        mesh, rounds=8, carry_chunks=carry_chunks,
        carry_layout=NARROW_LAYOUT if carry_chunks else None,
    )(JPacked(*_stack(T))))


@pytest.mark.parametrize("carry_chunks", [0, 4])
@pytest.mark.parametrize("T", [3, 5, 8])
@pytest.mark.parametrize("n", [2, 4])
def test_tenant_mesh_batch_matches_jax(n, T, carry_chunks):
    """T tenants over a tenant mesh of n: the service pads T to a
    multiple of n with inert all-zero tenants, the blocks solve on their
    devices and the pads are sliced off; the rows equal the JAX
    package's, and its own mesh program's where T divides."""
    svc = PlannerService(ReschedulerConfig(), clock=FakeClock(),
                         batch_window_s=0, device="cpu", devices=CPU[:n])
    padded = svc._pad_tenant_axis(to_device(_stack(T), "cpu"))
    assert padded.slot_req.shape[0] == -(-T // n) * n
    assert not padded.cand_valid[T:].any()  # pad tenants have no lane
    mesh = make_tenant_mesh(CPU[:n])
    planner = tenant_batch.make_tenant_batch_planner(
        mesh, rounds=8, carry_chunks=carry_chunks,
        carry_layout=NARROW_LAYOUT if carry_chunks else None)
    got = planner(padded)[:T].numpy()
    want = _jax_rows(T, carry_chunks)
    assert got.dtype == np.int32 and np.array_equal(got, want)
    # a T the mesh does not divide solves where it lies, the same rows
    assert np.array_equal(planner(to_device(_stack(T), "cpu")).numpy(),
                          want)
    if T == 8 and carry_chunks == 0 and n == 4:
        assert np.array_equal(want, _jax_rows(8, 0, n=4))


def test_blocks_launch_their_greedy_passes_before_any_repair_sync(
        monkeypatch):
    """Over a mesh of 4, every block's B1t/B2t pass runs before the first
    block's repair sync; each block is one B1t and one B2t call."""
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels

    order = []
    real = ffd_kernels.plan_ffd_tenants_kernel

    def spy(stacked, best_fit=False):
        order.append(("B2t" if best_fit else "B1t",
                      stacked.slot_req.shape[0]))
        return real(stacked, best_fit)

    monkeypatch.setattr(ffd_kernels, "plan_ffd_tenants_kernel", spy)
    real_repair = tenant_batch.tenant_slice

    def repair_probe(stacked, t):
        order.append(("slice", t))
        return real_repair(stacked, t)

    monkeypatch.setattr(tenant_batch, "tenant_slice", repair_probe)
    rows = tenant_batch.plan_tenants_batched(
        make_tenant_mesh(CPU[:4]), to_device(_stack(8), "cpu"), rounds=8)
    assert np.array_equal(rows.numpy(), _jax_rows(8))
    first = next(i for i, o in enumerate(order) if o[0] == "slice")
    assert order[:first] == [("B1t", 2), ("B2t", 2)] * 4


def test_tenant_schedules_over_the_mesh_equal_one_device():
    stacked = to_device(_stack(5), "cpu")
    svc = PlannerService(ReschedulerConfig(), clock=FakeClock(),
                         batch_window_s=0, device="cpu", devices=CPU[:4])
    one = tenant_batch.make_tenant_schedule_planner(
        horizon=4, rounds=8)(stacked)
    mesh = tenant_batch.make_tenant_schedule_planner(
        make_tenant_mesh(CPU[:4]), horizon=4, rounds=8)(
        svc._pad_tenant_axis(stacked))
    assert mesh.shape == (8, 4, one.shape[2])
    assert torch.equal(mesh[:5], one)
    # pad tenants: the first probe finds nothing, the rest stay -1
    assert (mesh[5:, 0, 1] == 0).all() and (mesh[5:, 1:] == -1).all()


def test_pad_tenant_axis_matches_the_jax_service():
    """The port's padding on host and on device stacks is the JAX
    service's over a tenant mesh of the same size, and a one-device
    service leaves the stack as it is."""
    for T in (3, 5, 8):
        host = _stack(T)
        jsvc = jax_server.PlannerService(JConfig(solver="jax"),
                                         clock=JFakeClock(),
                                         batch_window_s=0)
        jsvc._mesh = jmesh.make_tenant_mesh(jax.devices()[:4])
        jsvc._mesh_ready = True
        want = jsvc._pad_tenant_axis(JPacked(*host))
        svc = PlannerService(ReschedulerConfig(), clock=FakeClock(),
                             batch_window_s=0, device="cpu", devices=CPU[:4])
        for got in (svc._pad_tenant_axis(host),
                    svc._pad_tenant_axis(to_device(host, "cpu"))):
            for f in PackedCluster._fields:
                g = getattr(got, f)
                g = g.numpy() if isinstance(g, torch.Tensor) else g
                w = np.asarray(getattr(want, f))
                assert np.array_equal(g.view(w.dtype), w), (T, f)
        one = PlannerService(ReschedulerConfig(), clock=FakeClock(),
                             batch_window_s=0, device="cpu")
        assert one._ensure_mesh() is None and one._pad_tenant_axis(host) is host


def test_drain_once_over_a_four_device_service_matches_the_jax_service():
    """Five tenants' requests in one batch of a 4-device service (padded
    to 8, two tenants a block) answer what the JAX service answers; the
    batch log names the five, not the pads."""
    b, packs = _tenants()
    jsvc = jax_server.PlannerService(JConfig(solver="jax"),
                                     clock=JFakeClock(), batch_window_s=0,
                                     max_batch_tenants=8)
    svc = PlannerService(ReschedulerConfig(), clock=FakeClock(),
                         batch_window_s=0, max_batch_tenants=8,
                         device="cpu", devices=CPU[:4])
    assert svc.batch_program() == (
        "tenant-batch(torch union, plain B1t/B2t on cpu, tenant mesh of 4)")
    names = [f"t{i}" for i in range(5)]
    jreqs = [jsvc.submit_nowait(t, JPacked(*p)) for t, p in zip(names, packs)]
    reqs = [svc.submit_nowait(t, p) for t, p in zip(names, packs)]
    assert jsvc.drain_once() and svc.drain_once()
    for got, want in zip(reqs, jreqs):
        assert got.error is None and want.error is None
        g, w = got.reply, want.reply
        assert (g.found, g.index, g.n_feasible) == (
            w.found, w.index, w.n_feasible)
        assert np.array_equal(g.row, w.row)
        assert g.batch_tenants == w.batch_tenants == 5
    log = svc.batch_log[-1]
    assert log["tenants"] == names and log["path"] == "device"
