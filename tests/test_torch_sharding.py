"""The port's mesh tiers on the CPU against the JAX package's.

The JAX side runs on the 8 virtual CPU devices ``tests/conftest.py``
forces; the port's meshes are ``[torch.device("cpu")] * n`` with the
kernels' plain versions. Every comparison is exact: feasible masks,
assignments, selections, tier labels, chunk counts, byte estimates and
gauges. Packs come from numpy generators with a seed, at one small
shape, so each JAX program compiles once.
"""

from __future__ import annotations

import functools
import json
import types

import jax
import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.models.tensors import PackedCluster as JPacked
from k8s_spot_rescheduler_tpu.parallel import mesh as jmesh
from k8s_spot_rescheduler_tpu.parallel import sharded_ffd as jsharded
from k8s_spot_rescheduler_tpu.solver import memory as jmemory
from k8s_spot_rescheduler_tpu.solver.carry import (
    NARROW_LAYOUT,
    WIDE_LAYOUT,
    CarryLayout,
    carry_layout,
)
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_oracle
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz
from k8s_spot_rescheduler_tpu_torch.parallel import mesh as tmesh
from k8s_spot_rescheduler_tpu_torch.parallel import sharded_ffd as tsharded
from k8s_spot_rescheduler_tpu_torch.solver import memory as tmemory
from k8s_spot_rescheduler_tpu_torch.testing import random_bits, random_pack
from tests.torch_port_fixtures import rung_budget

torch.set_num_threads(1)

CPU = [torch.device("cpu")] * 8
C, K, S, R = 13, 6, 11, 2  # uneven on every mesh axis below
MESHES = [(1, 1), (2, 1), (2, 2), (4, 2), (1, 4)]
GUARDED = CarryLayout(used="float32", count="int8", aff="uint8")


def _pack(seed: int):
    """A random pack whose lanes' affinity words fit 16 bits, so
    NARROW_LAYOUT is exact for it."""
    rng = np.random.default_rng(seed)
    p = random_pack(rng, C, K, S, R)
    p = p._replace(slot_aff=random_bits(rng, (C, K, 2), top=16))
    assert carry_layout(JPacked(*p)) == NARROW_LAYOUT
    return p


def _tie_pack():
    """Best-fit ties across spot shards: the tightest fits sit at spots
    3, 6 and 9 (one in each shard of a 4-way spot axis), so each election
    must go to the lowest global index."""
    p = _pack(7)
    free = np.array([100, 100, 100, 50, 80, 80, 50, 80, 80, 50, 80],
                    np.float32)
    return p._replace(
        slot_req=np.broadcast_to(np.array([30, 10], np.float32),
                                 (C, K, R)).copy(),
        slot_tol=np.repeat(np.arange(C, dtype=np.uint32)[:, None] % 2,
                           K, axis=1)[..., None],
        slot_aff=np.zeros((C, K, 2), np.uint32),
        slot_valid=np.ones((C, K), bool),
        cand_valid=np.ones(C, bool),
        spot_free=np.stack([free, np.full(S, 100, np.float32)], axis=1),
        spot_count=np.zeros(S, np.int32),
        spot_max_pods=np.full(S, 50, np.int32),
        spot_taints=np.array([[1]] * 3 + [[0]] * 8, np.uint32),
        spot_ok=np.ones(S, bool),
        spot_aff=np.zeros((S, 2), np.uint32),
    )


def _repair_pack(seed: int = 11):
    """Lane 0 is ``tests/test_repair._swap_case`` (greedy strands its
    selector-pinned pod; one relocation proves it), on spots 0-1; the
    other spots carry a taint lane 0 does not tolerate."""
    p = _pack(seed)
    big = 10_000
    slot_req = p.slot_req.copy()
    slot_valid = p.slot_valid.copy()
    slot_tol = p.slot_tol.copy()
    slot_aff = p.slot_aff.copy()
    slot_req[0] = 0
    slot_req[0, :3, 0] = [6, 5, 5]
    slot_valid[0] = [True] * 3 + [False] * (K - 3)
    slot_tol[0, :, 0] = [1, 1, 0] + [0] * (K - 3)
    slot_aff[0] = 0
    spot_free = p.spot_free.copy()
    spot_free[:2] = [[11, big], [5, big]]
    spot_taints = p.spot_taints | np.uint32(2)
    spot_taints[:2, 0] = [0, 1]
    cand_valid = p.cand_valid.copy()
    cand_valid[0] = True
    spot_count = p.spot_count.copy()
    spot_count[:2] = 0
    spot_max = p.spot_max_pods.copy()
    spot_max[:2] = 10
    spot_ok = p.spot_ok.copy()
    spot_ok[:2] = True
    spot_aff = p.spot_aff.copy()
    spot_aff[:2] = 0
    return p._replace(
        slot_req=slot_req, slot_valid=slot_valid, slot_tol=slot_tol,
        slot_aff=slot_aff, cand_valid=cand_valid, spot_free=spot_free,
        spot_count=spot_count, spot_max_pods=spot_max,
        spot_taints=spot_taints, spot_ok=spot_ok, spot_aff=spot_aff,
    )


def _same(got, want):
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(want.feasible))
    np.testing.assert_array_equal(got.assignment.numpy(),
                                  np.asarray(want.assignment))


@functools.lru_cache(maxsize=None)
def _jax_2d(shape, best_fit: bool, layout):
    return jax.jit(functools.partial(
        jsharded.plan_ffd_sharded, jmesh.make_mesh(shape),
        best_fit=best_fit, layout=layout))


@functools.lru_cache(maxsize=None)
def _jax_cand(n: int, **kw):
    mesh = jmesh.make_cand_mesh(jax.devices()[:n])
    return jax.jit(lambda p: jsharded.plan_union_cand_sharded(
        mesh, p, rounds=8, **kw))


# --- parallel/mesh ------------------------------------------------------------


@pytest.mark.parametrize("n", range(1, 17))
def test_pick_mesh_shape_matches_jax(n):
    assert tmesh.pick_mesh_shape(n) == jmesh.pick_mesh_shape(n)


@pytest.mark.parametrize("shape", [None, (1, 1), (2, 1), (2, 2), (4, 2),
                                   (1, 4), (8, 1), (3, 3), (2, 8)])
def test_make_mesh_shapes_and_errors_match_jax(shape):
    try:
        want = jmesh.make_mesh(shape)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            tmesh.make_mesh(shape, CPU)
        assert str(got.value) == str(err)
        return
    got = tmesh.make_mesh(shape, CPU)
    assert got.shape == dict(want.shape)
    assert got.axis_names == tuple(want.axis_names)
    assert got.devices.shape == want.devices.shape
    assert tmesh.make_cand_mesh(CPU[:3]).shape == dict(
        jmesh.make_cand_mesh(jax.devices()[:3]).shape)
    assert tmesh.make_tenant_mesh(CPU[:5]).shape == dict(
        jmesh.make_tenant_mesh(jax.devices()[:5]).shape)


def test_default_devices_and_lead():
    assert tmesh.default_devices("cpu") == [torch.device("cpu")]
    mesh = tmesh.make_mesh((2, 2), [torch.device("cpu")] * 4)
    assert mesh.lead == torch.device("cpu")
    with pytest.raises(ValueError, match="cand mesh"):
        tsharded.plan_union_cand_sharded(mesh, _pack(0))


# --- parallel/sharded_ffd: the 2-D tier ----------------------------------------


@pytest.mark.parametrize("layout", ["wide", "narrow"])
@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("shape", MESHES)
def test_plan_ffd_sharded_matches_jax(shape, best_fit, layout):
    lay = WIDE_LAYOUT if layout == "wide" else NARROW_LAYOUT
    packs = [_pack(seed) for seed in range(3)]
    if best_fit:
        packs.append(_tie_pack())
    mesh = tmesh.make_mesh(shape, CPU)
    for p in packs:
        want = _jax_2d(shape, best_fit, lay)(JPacked(*p))
        got = tsharded.plan_ffd_sharded(mesh, p, best_fit=best_fit,
                                        layout=lay)
        _same(got, want)
        # the 2-D tier is layout-free: the serial oracle's answer
        _same(got, plan_oracle(JPacked(*p), best_fit=best_fit))


def test_best_fit_tie_goes_to_the_lowest_global_index():
    p = _tie_pack()
    got = tsharded.plan_ffd_sharded(tmesh.make_mesh((1, 4), CPU), p,
                                    best_fit=True)
    # lane 1 tolerates shard 0's taint, lane 0 does not: both place
    # their first three pods on the ties across shards 1, 2 and 3
    assert got.assignment[0].tolist()[:4] == [3, 6, 9, 4]
    assert got.assignment[1].tolist()[:4] == [3, 6, 9, 4]


def test_torch_blocks_of_a_device_pack_land_on_the_lead():
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device

    p = _pack(2)
    got = tsharded.plan_ffd_sharded(tmesh.make_mesh((2, 2), CPU),
                                    to_device(p, "cpu"))
    _same(got, plan_oracle(JPacked(*p)))
    assert got.assignment.dtype == torch.int32


# --- parallel/sharded_ffd: the cand tier ---------------------------------------


CAND_CASES = {
    "repair": dict(repair_spot_chunks=1),
    "repair-chunked-4": dict(repair_spot_chunks=4),
    "carry-4-narrow": dict(carry_chunks=4, carry_layout=NARROW_LAYOUT),
    "carry-4-guarded": dict(carry_chunks=4, carry_layout=GUARDED),
}


@pytest.mark.parametrize("case", list(CAND_CASES))
def test_plan_union_cand_sharded_matches_jax(case):
    kw = CAND_CASES[case]
    rp = _repair_pack()
    greedy = plan_oracle(JPacked(*rp))
    assert not greedy.feasible[0]  # greedy strands lane 0
    for p in (_pack(20), rp):
        want = _jax_cand(4, **kw)(JPacked(*p))
        # lane blocks never interact: every block count gives JAX's lanes
        for n in (2, 4):
            got = tsharded.plan_union_cand_sharded(
                tmesh.make_cand_mesh(CPU[:n]), p, rounds=8, use_kernel=True,
                **kw)
            _same(got, want)
    assert bool(got.feasible[0])  # repair proved it


def test_cand_tier_launches_every_block_before_any_sync(monkeypatch):
    """Every block's greedy passes run before the first repair sync."""
    from k8s_spot_rescheduler_tpu_torch.solver import fallback

    order = []
    real = fallback._needs_repair
    real_prefer = fallback._prefer

    def needs(packed, union):
        order.append("sync")
        return real(packed, union)

    def prefer(first, then):
        order.append("greedy")
        return real_prefer(first, then)

    monkeypatch.setattr(fallback, "_needs_repair", needs)
    monkeypatch.setattr(fallback, "_prefer", prefer)
    tsharded.plan_union_cand_sharded(tmesh.make_cand_mesh(CPU[:4]),
                                     _pack(3), rounds=8)
    first_sync = order.index("sync")
    assert order[:first_sync] == ["greedy"] * 4


# --- solver/memory ---------------------------------------------------------------


def test_should_shard_matches_jax():
    for seed in range(3):
        p = _pack(seed)
        for n in (1, 2, 8):
            for budget in (None, 1, 10**6, 10**12):
                for chunks in (0, 1):
                    kw = dict(budget_bytes=budget, repair_spot_chunks=chunks)
                    assert tmemory.should_shard(p, n, **kw) == (
                        jmemory.should_shard(JPacked(*p), n, **kw))
    assert not tmemory.should_shard(_pack(0), 8)
    assert not tmemory.should_shard(_pack(0), 1, budget_bytes=1)
    assert tmemory.should_shard(_pack(0), 8, budget_bytes=1)


# the probe points tests/test_sharding.py pins: config 3 at 1x-8x, and the
# 20x shapes at the v5e-8 default budget
PROBES = [(2560 * m, 32, 2560 * m, 4, 2, 2) for m in (1, 2, 4, 8)] + [
    (51_200, 32, 51_200, 4, 2, 2)]


@pytest.mark.parametrize("shapes", PROBES)
def test_pick_tier_matches_jax_on_the_pinned_probes(shapes):
    from k8s_spot_rescheduler_tpu.solver.carry import plane_bytes

    base = int(jmemory.DEFAULT_HBM_BYTES * jmemory.BUDGET_FRACTION)
    for n in (1, 4, 8):
        for budget in (base, base // 8, base // 64, 1):
            for lay in (None, NARROW_LAYOUT, GUARDED):
                for forced in (0, 4):
                    kw = dict(
                        n_devices=n, budget_bytes=budget,
                        carry_plane_bytes=(
                            plane_bytes(lay, shapes[3], shapes[5])
                            if lay else None),
                        forced_carry_chunks=forced,
                    )
                    assert tmemory.pick_tier(*shapes, **kw) == (
                        jmemory.pick_tier(*shapes, **kw)), (n, budget, lay)


# --- the planner's dispatch ladder -----------------------------------------------


def _ladder_pack(seed: int = 0):
    """Wide enough (S=260) for the chunked and carry rungs."""
    rng = np.random.default_rng(seed)
    p = random_pack(rng, 16, 4, 260, 2, req_max=40)
    return p._replace(slot_aff=random_bits(rng, (16, 4, 2), top=16))


RUNGS = [("cand", (1, 1)), ("cand-chunked", (1, 1)), ("cand-carry", (1, 1)),
         ("2d", (4, 2)), ("2d", (2, 2))]


@pytest.mark.parametrize("kind,mesh_shape", RUNGS)
def test_every_rung_of_the_ladder_matches_jax(kind, mesh_shape):
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import (
        ReschedulerConfig as JConfig,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    p = _ladder_pack()
    budget = rung_budget(kind, JPacked(*p), len(jax.devices()))
    jp = SolverPlanner(JConfig(solver_hbm_budget=budget,
                               mesh_shape=mesh_shape))
    fused, label, dropped, repair_chunks, carry_chunks, carry_bytes = (
        jp._maybe_shard(JPacked(*p)))
    want = np.asarray(fused(JPacked(*p)))
    tp = TorchSolverPlanner(
        ReschedulerConfig(solver_hbm_budget=budget, mesh_shape=mesh_shape),
        device="cpu", devices=CPU)
    sel = tp.plan_packed(p)
    got = np.concatenate([[sel.index, int(sel.found), sel.n_feasible],
                          sel.row])
    np.testing.assert_array_equal(got, want)
    assert tp.last_dispatch == (label.replace("jax", "torch", 1), dropped,
                                repair_chunks, carry_chunks, carry_bytes)
    assert tp.last_solver == tp.last_dispatch[0] != "torch"
    if kind == "cand-carry":
        assert carry_chunks > 1
    # the schedule program is single-device: no schedule on a mesh rung
    assert tp.plan_schedule_packed(p) is None
    assert tp._device_packed is None  # the reroute holds no resident cache


def _quality_observations():
    """The contended quality cluster in both packages (repair fires)."""
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        QUALITY_CONFIGS as JQ,
        generate_quality_cluster as jgen,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        QUALITY_CONFIGS as TQ,
        generate_quality_cluster as tgen,
    )

    out = []
    for configs, gen in ((JQ, jgen), (TQ, tgen)):
        spec = configs["contended"]
        client = gen(spec, 0)
        store = client.columnar_store(
            spec.resources,
            on_demand_label="kubernetes.io/role=worker",
            spot_label="kubernetes.io/role=spot-worker",
        )
        out.append((store, client.list_pdbs(), spec.resources))
    return out


def _jax_gauges():
    from k8s_spot_rescheduler_tpu.metrics import registry as m

    mode = {(s.labels["configured"], s.labels["running"])
            for s in m.solver_mode.collect()[0].samples if s.value}
    return (mode, *(g.collect()[0].samples[0].value for g in (
        m.repair_unavailable, m.solver_repair_chunks, m.solver_carry_chunks,
        m.solver_carry_bytes)))


def _port_gauges():
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as m

    mode = {k for k, v in m.solver_mode.values.items() if v}
    return (mode, *(g.value() for g in (
        m.repair_unavailable, m.solver_repair_chunks, m.solver_carry_chunks,
        m.solver_carry_bytes)))


def test_plan_reports_gauges_and_the_repair_edge_match_jax():
    """plan() at the cand rung, the 2-D rung (repair_unavailable fires)
    and back at the single tier (it clears, the resident cache uploads
    in full), against the JAX planner on the same cluster."""
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import (
        ReschedulerConfig as JConfig,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    (jstore, jpdbs, res), (tstore, tpdbs, _) = _quality_observations()
    probe = SolverPlanner(JConfig(resources=res))
    packed, _ = probe._pack_observation(jstore, jpdbs)
    n = len(jax.devices())
    budgets = [rung_budget("cand", packed, n), 1, 0]
    tp = TorchSolverPlanner(ReschedulerConfig(resources=res), device="cpu",
                            devices=CPU)
    jp = SolverPlanner(JConfig(resources=res))
    for budget in budgets:
        jp.config = JConfig(resources=res, solver_hbm_budget=budget)
        tp.config = ReschedulerConfig(resources=res, solver_hbm_budget=budget)
        want = jp.plan(jstore, jpdbs)
        want_gauges = _jax_gauges()
        got = tp.plan(tstore, tpdbs)
        got_gauges = _port_gauges()
        assert got.solver == want.solver.replace("jax", "torch", 1)
        assert (got.n_feasible, got.repair_chunks, got.carry_chunks) == (
            want.n_feasible, want.repair_chunks, want.carry_chunks)
        assert (got.plan is None) == (want.plan is None)
        if want.plan is not None:
            assert got.plan.node.node.name == want.plan.node.node.name
            assert got.plan.assignments == want.plan.assignments
        assert got_gauges[0] == {
            tuple(x.replace("jax", "torch", 1) for x in pair)
            for pair in want_gauges[0]}
        assert got_gauges[1:] == want_gauges[1:]
    assert got.solver == "torch" and got.full_repack  # back in full
    assert want_gauges[1] == 0.0


def test_plan_schedule_goes_per_tick_on_a_mesh_rung():
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    _, (tstore, tpdbs, res) = _quality_observations()
    planner = TorchSolverPlanner(
        ReschedulerConfig(resources=res, solver_hbm_budget=1), device="cpu",
        devices=CPU[:4])
    assert planner.plan_schedule(tstore, tpdbs) is None
    sched = TorchSolverPlanner(
        ReschedulerConfig(resources=res, solver_hbm_budget=1,
                          solver="sharded"),
        device="cpu", devices=CPU[:4])
    assert sched.plan_schedule(tstore, tpdbs) is None
    one = TorchSolverPlanner(
        ReschedulerConfig(resources=res, solver_hbm_budget=1), device="cpu",
        devices=CPU[:1])
    assert one.plan_schedule(tstore, tpdbs) is not None  # one device: single


def test_auto_shard_off_keeps_the_configured_path():
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as m
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    p = _ladder_pack(1)
    want = TorchSolverPlanner(ReschedulerConfig(), device="cpu",
                              devices=CPU[:1]).plan_packed(p)
    for cfg in (ReschedulerConfig(solver_hbm_budget=1, auto_shard=False),
                ReschedulerConfig()):
        planner = TorchSolverPlanner(cfg, device="cpu", devices=CPU)
        got = planner.plan_packed(p)
        assert planner.last_dispatch[:4] == ("torch", False, 1, 0)
        assert (got.index, got.n_feasible) == (want.index, want.n_feasible)
        np.testing.assert_array_equal(got.row, want.row)
        assert planner._device_packed is not None  # the resident cache
    m.update_solver_mode("torch", "torch", False, repair_chunks=1,
                         carry_chunks=0, carry_bytes=-1)
    assert m.repair_unavailable.value() == 0.0


def test_configured_sharded_solver_matches_jax():
    """``solver="sharded"``: the 2-D greedy passes under the union, repair
    on the mesh's first device; its label never changes."""
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu.utils.config import (
        ReschedulerConfig as JConfig,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    p = _repair_pack()
    jp = SolverPlanner(JConfig(solver="sharded", solver_hbm_budget=1))
    want = np.asarray(jp._fused(JPacked(*p)))
    tp = TorchSolverPlanner(
        ReschedulerConfig(solver="sharded", solver_hbm_budget=1),
        device="cpu", devices=CPU)
    sel = tp.plan_packed(p)
    np.testing.assert_array_equal(
        np.concatenate([[sel.index, int(sel.found), sel.n_feasible],
                        sel.row]), want)
    assert tp.last_dispatch == ("sharded", False, 1, 0, -1)
    assert tp._mesh().shape == {"cand": 4, "spot": 2}


# --- config, CLI ------------------------------------------------------------------


def test_mesh_knobs_and_their_validation_match_jax():
    from k8s_spot_rescheduler_tpu.utils.config import (
        ReschedulerConfig as JConfig,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import (
        SOLVERS,
        ReschedulerConfig,
    )

    for knob in ("mesh_shape", "auto_shard", "solver_hbm_budget",
                 "carry_chunks"):
        assert getattr(ReschedulerConfig(), knob) == getattr(JConfig(), knob)
    assert "sharded" in SOLVERS
    for cls in (JConfig, ReschedulerConfig):
        with pytest.raises(ValueError, match="carry_chunks"):
            cls(carry_chunks=-1)


def test_cli_mesh_flags_parse_as_the_jax_cli():
    from k8s_spot_rescheduler_tpu.cli.main import (
        build_parser as jparser,
        config_from_args as jconfig,
    )
    from k8s_spot_rescheduler_tpu_torch.cli.main import (
        build_parser,
        config_from_args,
    )

    for argv in ([], ["--mesh-shape", "2x2"], ["--mesh-shape", "4X2"],
                 ["--solver", "sharded", "--mesh-shape", "1x1"],
                 ["--auto-shard", "false", "--solver-hbm-budget", "4096",
                  "--carry-chunks", "8"]):
        got = config_from_args(build_parser().parse_args(argv))
        want = jconfig(jparser().parse_args(argv))
        for knob in ("mesh_shape", "auto_shard", "solver_hbm_budget",
                     "carry_chunks"):
            assert getattr(got, knob) == getattr(want, knob), (argv, knob)
        assert got.solver == ("sharded" if "sharded" in argv else "torch")
    for bad in ("2", "2x", "ax2", "0x2", "2x2x2"):
        with pytest.raises(SystemExit):
            build_parser().parse_args(["--mesh-shape", bad])


def test_cli_sharded_solver_drains_as_the_jax_cli():
    """``--solver sharded --mesh-shape 1x1`` on config 1 in process, on
    the CPU, against the JAX CLI with the same flags."""
    from k8s_spot_rescheduler_tpu.cli.main import (
        build_parser as jparser,
        config_from_args as jconfig,
    )
    from k8s_spot_rescheduler_tpu.io.synthetic import (
        CONFIGS as JCONFIGS,
        generate_cluster as jgen,
    )
    from k8s_spot_rescheduler_tpu.loop.controller import (
        Rescheduler as JRescheduler,
    )
    from k8s_spot_rescheduler_tpu.planner.solver_planner import SolverPlanner
    from k8s_spot_rescheduler_tpu_torch.cli.main import (
        build_parser,
        config_from_args,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    argv = ["--cluster", "synthetic:1", "--ticks", "3", "--solver",
            "sharded", "--mesh-shape", "1x1", "--no-metrics-server",
            "--node-drain-delay", "1s"]
    jcfg = jconfig(jparser().parse_args(argv))
    jclient = jgen(JCONFIGS[1], 0, reschedule_evicted=True)
    want = testing.run_ticks(
        JRescheduler(jclient, SolverPlanner(jcfg), jcfg, clock=jclient.clock,
                     recorder=jclient), jclient, 3)
    cfg = config_from_args(build_parser().parse_args(argv))
    client = generate_cluster(CONFIGS[1], 0, reschedule_evicted=True)
    planner = TorchSolverPlanner(cfg, device="cpu", devices=CPU[:4])
    got = testing.run_ticks(
        Rescheduler(client, planner, cfg, clock=client.clock,
                    recorder=client), client, 3)
    assert got == want
    assert any(rec["drained"] for rec in got)
    assert planner.last_solver == "sharded"


# --- --scale-smoke ----------------------------------------------------------------


def test_scale_smoke_matches_the_root_bench(monkeypatch, capsys):
    import bench

    rows = []
    monkeypatch.setattr(bench, "emit", rows.append)
    assert bench.run_scale_smoke(types.SimpleNamespace(),
                                 "scale_smoke_20x_shape_proof_s", "s") == 0
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import run

    rc, row = run(["--device", "cpu", "--scale-smoke"])
    assert rc == 0
    want = rows[0]
    timing = {"value", "trace_ms", "trace_eqns", "geometry_ms", "geometry",
              "wall_s", "launches", "backend_attestation"}
    assert {k: v for k, v in row.items() if k not in timing} == {
        k: v for k, v in want.items() if k not in timing}
    assert set(row["geometry"]) == set(want["trace_eqns"]) == {
        "narrow", "guarded"}
    for geo in row["geometry"].values():
        for g in geo.values():
            assert g["lanes_per_block"] >= 1 and g["lanes_in_smem"]
    assert sum(row["launches"].values()) == 0  # shape only, no solve
    frozen = json.loads(str(load_npz(testing.SHARDED_PATH)[1]["scale_smoke"]))
    for key in ("carry_chunks", "carry_bytes", "repair_chunks",
                "narrow_carry_chunks", "lane_block", "est_device_gb",
                "budget_gb", "breakdown_mb"):
        assert row[key] == frozen[key] == want[key], key


# --- the frozen answers of the chip smoke ------------------------------------------


def test_frozen_sharded_answers_fit_their_packs():
    """``data/sharded_seed0.npz`` (``tests/torch_port_fixtures.py
    sharded``): keys and shapes against the packs it names; the JAX
    solves are not re-run at config-3 size."""
    host, ans = load_npz(testing.SHARDED_PATH)
    Cc, Kc, Rc = host.slot_req.shape
    assert (Cc, Kc, host.spot_free.shape[0]) == (2560, testing.SHARDED_SLOTS,
                                                 2560)
    assert int(ans["devices"]) == testing.SHARDED_DEVICES
    for name, kind, _ in testing.SHARDED_RUNGS:
        key = f"config3_{name}"
        assert ans[f"{key}_selection"].shape == (3 + Kc,)
        assert str(ans[f"{key}_kind"]) == kind
        assert ans[f"{key}_dispatch"].shape == (4,)
        assert str(ans[f"{key}_label"]).startswith("jax+")
        # the tier a budget lands on is the port's verdict too
        tier = tmemory.pick_tier(
            *tmemory.packed_shapes(host), n_devices=testing.SHARDED_DEVICES,
            budget_bytes=int(ans[f"{key}_budget"]),
            carry_plane_bytes=lambda h=host: _plane_bytes(h))
        assert tier.kind == kind
        assert [int(tier.repair_unavailable), tier.repair_chunks,
                tier.carry_chunks, tier.carry_bytes] == ans[
            f"{key}_dispatch"].tolist()
    sources = {"contended": "contended_seed0.npz",
               "harvest": "replay_harvest_seed0.npz"}
    for pack in testing.SHARDED_PACKS:
        other, _ = load_npz(testing.SHARDED_PATH.replace(
            "sharded_seed0.npz", sources[pack]))
        C2, K2, _ = other.slot_req.shape
        for name, kind, _ in testing.SHARDED_PACK_RUNGS:
            key = f"{pack}_{name}"
            assert ans[f"{key}_feasible"].shape == (C2,)
            assert ans[f"{key}_assignment"].shape == (C2, K2)
            assert ans[f"{key}_selection"].shape == (3 + K2,)
            assert int(ans[f"{key}_selection"][2]) == int(
                ans[f"{key}_feasible"].sum())
    cli = json.loads(str(ans["cli"]))
    assert cli["args"] == list(testing.SHARDED_CLI_ARGS)
    assert len(cli["records"]) == 3


def _plane_bytes(host):
    from k8s_spot_rescheduler_tpu_torch.solver import carry

    _, _, _, R, _, A = tmemory.packed_shapes(host)
    return carry.plane_bytes(carry.carry_layout(host), R, A)
