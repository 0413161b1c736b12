"""The port's bench layer (``k8s_spot_rescheduler_tpu_torch/bench``) on
the CPU, held against the JAX package's ``bench/`` on the same seeded
inputs.

Tolerance: exact for every count, drain, evicted pod UID, ILP and LP
value and chain-depth counter; the protocol arithmetic to 1e-9 ms (the
JAX module's own tolerance); equal JSON keys and metric names for the
driver. The JAX side plans with its default ``solver="jax"`` (XLA, no
Pallas on these paths); the port's with ``solver="torch"`` on the CPU,
where kernels B1/B2 take their plain versions.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
from typing import NamedTuple

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.bench import chain_depth as ref_chain
from k8s_spot_rescheduler_tpu.bench import protocol as ref_protocol
from k8s_spot_rescheduler_tpu.bench import quality as ref_quality
from k8s_spot_rescheduler_tpu.bench.replay import run_replay as ref_run_replay
from k8s_spot_rescheduler_tpu.io import synthetic as ref_synthetic
from k8s_spot_rescheduler_tpu.models.cluster import NodeInfo as RefNodeInfo
from k8s_spot_rescheduler_tpu.models.cluster import NodeMap as RefNodeMap
from k8s_spot_rescheduler_tpu.models.tensors import (
    pack_cluster as ref_pack_cluster,
)
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch.bench import chain_depth
from k8s_spot_rescheduler_tpu_torch.bench import protocol
from k8s_spot_rescheduler_tpu_torch.bench import quality
from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
    build_parser,
    metric_for,
)
from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay
from k8s_spot_rescheduler_tpu_torch.io import synthetic
from k8s_spot_rescheduler_tpu_torch.models import cluster as port_cluster
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    pack_cluster,
)
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ("quality-test", 8, 8, 80)  # tests/test_quality.py's SMALL
# tests/test_chain_depth.py's positive-control spec
CHAIN3_CONTROL = dict(n_groups=6, aswap_frac=0.0, chain3_frac=1 / 3)


def _port_pack(packed) -> PackedCluster:
    """A JAX-package host pack as the port's PackedCluster (same fields,
    same numpy arrays)."""
    return PackedCluster(*(np.asarray(getattr(packed, f))
                           for f in PackedCluster._fields))


def _pack_object_path(client, cfg, build_node_map, pack, resources):
    nodes = client.list_ready_nodes()
    nm = build_node_map(
        nodes,
        {n.name: client.list_pods_on_node(n.name) for n in nodes},
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
        priority_threshold=cfg.priority_threshold,
    )
    return pack(nm, client.list_pdbs(), resources=resources)[0]


# --- protocol ------------------------------------------------------------------

PROTOCOL_CASES = (
    ([0.081, 0.080, 0.079], [0.060, 0.061, 0.060], 50),
    ([0.080, 0.080, 10.0], [0.060, 0.060, 5.0], 50),
    ([0.055], [0.060], 50),
    ([], [0.06], 50),
    ([0.08], [], 50),
    ([0.08], [0.06], 0),
    ([0.080], [0.060], 50),
    ([0.0125, 0.0131], [0.00002], 7),
)


def test_protocol_chain_length_equals_the_jax_package():
    assert protocol.N_CHAIN == ref_protocol.N_CHAIN == 50


@pytest.mark.parametrize("chain,rtt,n", PROTOCOL_CASES)
def test_protocol_arithmetic_equals_the_jax_package(chain, rtt, n):
    got = protocol.device_only_ms(chain, rtt, n)
    want = ref_protocol.device_only_ms(chain, rtt, n)
    if math.isnan(want):
        assert math.isnan(got)
        return
    assert abs(got - want) < 1e-9
    if chain and rtt:
        assert protocol.protocol_record(chain, rtt, n) == (
            ref_protocol.protocol_record(chain, rtt, n))


class _P(NamedTuple):
    slot_req: torch.Tensor
    cand_valid: torch.Tensor


@pytest.mark.parametrize("n", (1, 7, 50))
def test_make_chained_runs_n_dependent_solves(n):
    """The chain runs the solver exactly n times, each on the previous
    result's perturbation (the stub sums slot_req, so a dropped
    iteration changes the total), as the JAX package's chain does."""
    p = _P(slot_req=torch.arange(6, dtype=torch.float32).reshape(2, 3),
           cand_valid=torch.ones(2, dtype=torch.bool))
    calls = []

    def fused(q):
        calls.append(q.slot_req)
        return q.slot_req

    got = float(protocol.make_chained(fused, n)(p))
    assert got == n * float(p.slot_req.sum())
    assert len(calls) == n
    assert all(c is not p.slot_req for c in calls)  # each a perturbed copy


def test_run_protocol_on_the_cpu_keeps_the_record_keys():
    p = _P(slot_req=torch.ones(4, 2), cand_valid=torch.ones(4, dtype=torch.bool))
    rec = protocol.run_protocol(lambda q: q.slot_req, p, reps=2, n_chain=3)
    assert set(rec) == set(ref_protocol.protocol_record([0.1], [0.1]))
    assert rec["chain_len"] == 3 and rec["device_only_ms"] >= 0.0


# --- the ILP and the LP bound ------------------------------------------------------


@pytest.mark.parametrize("seed", range(3))
def test_ilp_and_lp_bound_equal_the_jax_package(seed):
    spec = synthetic.SyntheticSpec(*SMALL)
    ref_spec = ref_synthetic.SyntheticSpec(*SMALL)
    from k8s_spot_rescheduler_tpu.models.cluster import (
        build_node_map as ref_build,
    )

    ours = _pack_object_path(
        synthetic.generate_cluster(spec, seed), ReschedulerConfig(),
        port_cluster.build_node_map, pack_cluster, ("cpu", "memory"))
    ref = _pack_object_path(
        ref_synthetic.generate_cluster(ref_spec, seed), RefConfig(),
        ref_build, ref_pack_cluster, ("cpu", "memory"))
    ilp = quality.ilp_max_drains(ours)
    assert ilp is not None
    assert ilp == ref_quality.ilp_max_drains(ref)
    assert quality.lp_upper_bound(ours) == ref_quality.lp_upper_bound(ref)
    # and on the very same arrays
    assert quality.ilp_max_drains(_port_pack(ref)) == ilp


def test_ilp_respects_capacity_as_the_jax_package():
    """tests/test_quality.py's capacity fixture: a candidate whose pod
    cannot fit anywhere counts for neither oracle."""
    from tests.fixtures import ON_DEMAND_LABELS, SPOT_LABELS, make_node, make_pod

    ref_packed, _ = ref_pack_cluster(RefNodeMap(
        on_demand=[RefNodeInfo.build(make_node("od", ON_DEMAND_LABELS),
                                     [make_pod("big", 1900, "od")])],
        spot=[RefNodeInfo.build(
            make_node("spot", SPOT_LABELS, cpu_millis=1000), [])],
    ))
    C = port_cluster
    od = C.NodeSpec(name="od", labels=dict(ON_DEMAND_LABELS),
                    allocatable={C.CPU: 2000, C.MEMORY: 2 * 1024**3,
                                 C.PODS: 100})
    spot = C.NodeSpec(name="spot", labels=dict(SPOT_LABELS),
                      allocatable={C.CPU: 1000, C.MEMORY: 2 * 1024**3,
                                   C.PODS: 100})
    big = C.PodSpec(name="big", namespace="default", node_name="od",
                    requests={C.CPU: 1900}, priority=0,
                    owner_refs=[C.OwnerRef("ReplicaSet", "big-rs")])
    packed, _ = pack_cluster(C.NodeMap(on_demand=[C.NodeInfo.build(od, [big])],
                                       spot=[C.NodeInfo.build(spot, [])]))
    assert quality.ilp_max_drains(packed) == ref_quality.ilp_max_drains(
        ref_packed) == 0
    assert quality.lp_upper_bound(packed) == ref_quality.lp_upper_bound(
        ref_packed)


@pytest.mark.parametrize("blocked", ((0,), (0, 1)), ids=("one-lane", "all-lanes"))
def test_ilp_with_slots_admissible_nowhere_equals_the_jax_package(blocked):
    """A candidate with a valid slot no spot admits is drained by no
    solution; when that holds for every candidate the port answers 0
    without HiGHS, otherwise it solves the full problem as the JAX
    package does."""
    from k8s_spot_rescheduler_tpu.models.tensors import (
        PackedCluster as RefPacked,
    )

    rng = np.random.default_rng(3)
    C, K, S, R, W, A = 2, 3, 4, 1, 1, 2
    slot_tol = np.ones((C, K, W), np.uint32)
    for c in blocked:
        slot_tol[c, 1] = 0  # tolerates no spot's taint bit
    ref = RefPacked(
        slot_req=rng.integers(1, 4, (C, K, R)).astype(np.float32),
        slot_valid=np.ones((C, K), bool),
        slot_tol=slot_tol,
        slot_aff=np.zeros((C, K, A), np.uint32),
        cand_valid=np.ones((C,), bool),
        spot_free=np.full((S, R), 10.0, np.float32),
        spot_count=np.zeros((S,), np.int32),
        spot_max_pods=np.full((S,), 10, np.int32),
        spot_taints=np.ones((S, W), np.uint32),
        spot_ok=np.ones((S,), bool),
        spot_aff=np.zeros((S, A), np.uint32),
    )
    want = ref_quality.ilp_max_drains(ref)
    assert quality.ilp_max_drains(_port_pack(ref)) == want
    assert want == C - len(blocked)


# --- drain to exhaustion -------------------------------------------------------------


def _drains(pkg_synthetic, pkg_quality, cfg_cls, spec, variant, **kw):
    knobs = ({"fallback_best_fit": False, "repair_rounds": 0}
             if variant == "ffd" else {})
    client = pkg_synthetic.generate_quality_cluster(
        spec, 0, reschedule_evicted=True)
    freed = pkg_quality.drain_to_exhaustion(
        client, cfg_cls(resources=spec.resources, **knobs), **kw)
    return freed, list(client.evictions)


@pytest.mark.parametrize("variant", ("ffd", "shipped"))
@pytest.mark.parametrize("name", ("balanced", "interlock", "spread",
                                  "chain3-control"))
def test_drain_to_exhaustion_equals_the_jax_package(name, variant):
    """Same drains and the same evicted pod UIDs in order, the port's
    controller on ``solver="torch"`` (CPU) against the JAX package's on
    ``solver="jax"``."""
    if name == "chain3-control":
        spec = synthetic.AffinitySpec("chain-depth-ctl", **CHAIN3_CONTROL)
        ref_spec = ref_synthetic.AffinitySpec("chain-depth-ctl",
                                              **CHAIN3_CONTROL)
    else:
        spec = synthetic.QUALITY_CONFIGS[name]
        ref_spec = ref_synthetic.QUALITY_CONFIGS[name]
    got = _drains(synthetic, quality, ReschedulerConfig, spec, variant,
                  device="cpu")
    want = _drains(ref_synthetic, ref_quality, RefConfig, ref_spec, variant)
    assert got == want
    if variant == "shipped":
        assert got[0] > 0


def test_drain_to_exhaustion_reports_fetches_and_keeps_the_columnar_path():
    spec = synthetic.QUALITY_CONFIGS["balanced"]
    client = synthetic.generate_quality_cluster(spec, 0, reschedule_evicted=True)
    stats: dict = {}
    packs = []
    freed = quality.drain_to_exhaustion(
        client, ReschedulerConfig(resources=spec.resources),
        planner_stats=stats, on_packed=packs.append, device="cpu")
    assert freed == 14
    assert stats["fetches_total"] >= 1 and isinstance(stats["schedule_lens"], list)
    assert all(p is None or isinstance(p.slot_req, np.ndarray) for p in packs)
    hinting = quality._HintingPlanner(object(), client)
    assert not hasattr(hinting, "accepts_columnar")  # delegates, adds nothing
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )

    inner = TorchSolverPlanner(ReschedulerConfig(), device="cpu")
    assert quality._HintingPlanner(inner, client).accepts_columnar


# --- replay -----------------------------------------------------------------------------


def test_replay_counts_equal_the_jax_package():
    """Config 5, 20 events, seed 1: every count field of the stats."""
    got = run_replay(ReschedulerConfig(), n_events=20, seed=1, device="cpu")
    want = ref_run_replay(RefConfig(), n_events=20, seed=1)
    assert set(got) == set(want)
    counts = [k for k in want if not k.startswith("replan_ms")]
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    assert got["ticks"] > 0 and got["stranded_by_drain"] == 0


# --- chain depth --------------------------------------------------------------------------


def _ref_cases():
    pytest.importorskip("hypothesis")  # tests.test_repair needs it
    from tests.test_repair import _rotation_coverage_case, _swap_case

    return {"swap": _swap_case, "rotation": _rotation_coverage_case}


@pytest.mark.parametrize("case", ("swap", "rotation"))
def test_classify_packed_equals_the_jax_package(case):
    packed = _ref_cases()[case]()
    got = chain_depth.classify_packed(_port_pack(packed), device="cpu")
    want = ref_chain.classify_packed(packed)
    assert dict(got) == dict(want)
    assert sum(got.values()) == int(np.asarray(packed.cand_valid).sum())


def test_chain3_control_counters_equal_the_jax_package():
    """The positive control: the port's analyzer (``solver="torch"``,
    greedy through the kernel wrappers) classifies every lane-tick of
    the chain3 control run as the JAX analyzer (numpy) does, with
    ``deeper`` lanes registered."""
    spec = synthetic.AffinitySpec("chain-depth-ctl", **CHAIN3_CONTROL)
    ref_spec = ref_synthetic.AffinitySpec("chain-depth-ctl", **CHAIN3_CONTROL)
    got = chain_depth.analyze_quality_runs(
        seeds=[0], configs={"chain3": spec}, device="cpu")
    want = ref_chain.analyze_quality_runs(seeds=[0], configs={"chain3": ref_spec})
    assert {k: dict(v) for k, v in got.items()} == {
        k: dict(v) for k, v in want.items()}
    assert got["chain3"]["deeper"] > 0


# --- the driver -----------------------------------------------------------------------------

METRIC_FLAGS = (
    [], ["--config", "1"], ["--config", "2"], ["--config", "4"],
    ["--config", "3", "--scale", "0.5"], ["--config", "5"],
    ["--config", "5", "--constrained"], ["--quality"],
    ["--quality-boundary"], ["--chain-depth"], ["--quality-scale"],
    ["--quality-scale", "--config", "4"], ["--replay-device-only"],
    ["--carry-wall"], ["--carry-wall", "--config", "4", "--scale", "0.5"],
    ["--smoke"], ["--pallas-smoke"], ["--chaos"], ["--watch-soak"],
    ["--serve-smoke"], ["--serve-smoke", "--tenants", "6"], ["--sched-smoke"],
    ["--fleet-chaos"], ["--fleet-twin-smoke"], ["--fleet-twin"],
    ["--storm-smoke"], ["--fleet-twin-smoke", "--twin-calibration", "x"],
    ["--solver", "sharded"], ["--config", "2", "--solver", "sharded"],
    ["--quality", "--solver", "numpy"],
    ["--quality-boundary", "--solver", "numpy"],
    ["--quality-scale", "--solver", "numpy"], ["--watchdog", "0"],
)
ROOT_FLAGS = ("chaos", "watch_soak", "smoke", "scale_smoke", "serve_smoke",
              "sched_smoke", "fleet_chaos", "fleet_twin_smoke", "fleet_twin",
              "storm_smoke", "pallas_smoke", "carry_wall", "replay_device_only")


@pytest.mark.parametrize("flags", METRIC_FLAGS, ids=lambda f: " ".join(f) or "default")
def test_driver_metric_names_equal_the_root_bench(flags):
    sys.path.insert(0, REPO)
    try:
        import bench as root_bench
    finally:
        sys.path.remove(REPO)
    args = build_parser().parse_args(flags)
    root_args = argparse.Namespace(**{**dict.fromkeys(ROOT_FLAGS, False), **vars(args)})
    assert metric_for(args) == root_bench._metric_for(root_args)


def _driver(*argv, device="cpu"):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    dev = ("--device", device) if device else ()
    return subprocess.run(
        [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch.bench", *dev,
         *argv],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300,
    )


def _one_row(out):
    lines = [ln for ln in out.stdout.splitlines() if ln.strip()]
    assert len(lines) == 1, out.stdout
    return json.loads(lines[0])


def test_driver_latency_row_on_the_cpu():
    out = _driver("--config", "1", "--repeats", "3")
    assert out.returncode == 0, out.stderr
    row = _one_row(out)
    assert row["metric"] == "drain_plan_ms_config1"
    assert row["backend_attestation"]["solve_backend"] == "cpu"
    assert row["backend_attestation"]["planner_fallbacks"] == 0
    assert set(row["device_only"]) == {"chain_len", "chain_ms", "rtt_ms",
                                       "device_only_ms"}
    assert row["launches"]["B1"] == 0  # plain versions on the CPU
    # the selection equals the JAX package's fused union on the same pack
    from k8s_spot_rescheduler_tpu.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu.solver.select import make_fused_planner
    from tests.torch_port_fixtures import pack_config

    want = np.asarray(make_fused_planner(union_program(8, True))(
        pack_config(1))).tolist()
    assert row["selection"] == want


def test_driver_replay_row_on_the_cpu():
    out = _driver("--config", "5", "--events", "20", "--seed", "1")
    assert out.returncode == 0, out.stderr
    row = _one_row(out)
    assert row["metric"] == "replay_replan_ms_p50_1k_events"
    assert row["backend_attestation"]["solve_backend"] == "cpu"
    want = ref_run_replay(RefConfig(), n_events=20, seed=1)
    assert set(row["stats"]) == set(want)
    assert row["stats"]["drained_nodes"] == want["drained_nodes"]


def test_driver_without_a_card_exits_nonzero_and_prints_no_row():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the driver would run on it")
    out = _driver("--config", "1", device=None)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "torch.cuda.is_available()" in out.stderr


@pytest.mark.parametrize("n,by_reason", ((3, {"unmodeled": 2}), (0, {})))
def test_conservatism_snapshot_equals_the_jax_package(n, by_reason):
    from k8s_spot_rescheduler_tpu.metrics import registry as ref_metrics
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics

    ref_metrics.update_conservatism(n, by_reason)
    metrics.update_conservatism(n, by_reason)
    got = metrics.conservatism_snapshot()
    assert got == ref_metrics.conservatism_snapshot()
    assert got["unplaceable_pods"] == n
