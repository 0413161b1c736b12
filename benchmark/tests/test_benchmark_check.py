"""The comparison that decides ``correct`` fails where it must: the
control (the reference with its taint guarantee broken, put in the
program's place) and each fault a cell can have, planted in the
program's timed path underneath a whole run (the harness's look for a
card skipped: the runs are on the CPU). The plain reference agrees with
the program's own serial oracle on several clusters of each
configuration's predicate mix. A run on the card of every cell is the
last test, marked ``cuda``."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest
import torch

from benchmark import generator, harness, plain
from benchmark.tests.conftest import ROOT, run_cpu

SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]
CONSTRAINED = [c for c in CELLS if "constrained" in c]


def _off(res) -> int:
    return sum(c["value"] for c in res["checks"].values())


@pytest.mark.parametrize("name", CELLS)
def test_the_control_comes_out_not_correct(tiny_cell, name):
    cell = tiny_cell(name, nodes=24)
    res = run_cpu(cell, 3, 1.0, control=True)
    assert not res["correct"]
    assert res["checks"]["placements_off"]["value"] > 0


def _mirror_keeps_its_state(monkeypatch):
    """The churn's pods never reach the mirror (removals dropped, pods
    the churn creates, ``pod-c<n>``, left out): a step that returns its
    state unchanged."""
    from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore

    real = ColumnarStore.add_pod

    def add_pod(self, pod):
        if not pod.name.startswith("pod-c"):
            real(self, pod)

    monkeypatch.setattr(ColumnarStore, "remove_pod", lambda self, uid: None)
    monkeypatch.setattr(ColumnarStore, "add_pod", add_pod)


def _schedule_never_commits(monkeypatch):
    """The schedule loop returns its spot state unchanged after each
    drain: every step re-solves the pool it started from."""
    from k8s_spot_rescheduler_tpu_torch.solver import schedule

    real = schedule.schedule_matrix

    def stale(solve_fn, packed, horizon):
        def solve(cur):
            return solve_fn(cur._replace(spot_free=packed.spot_free,
                                         spot_count=packed.spot_count,
                                         spot_aff=packed.spot_aff))

        return real(solve, packed, horizon)

    monkeypatch.setattr(schedule, "schedule_matrix", stale)


def _half_the_lanes(monkeypatch):
    """The union solves only the first half of the candidate lanes."""
    from k8s_spot_rescheduler_tpu_torch.planner import solver_planner

    real = solver_planner.union_program

    def half(*a, **kw):
        union = real(*a, **kw)

        def solve(packed):
            res = union(packed)
            keep = torch.arange(res.feasible.shape[0]) < (
                res.feasible.shape[0] + 1) // 2
            return res._replace(feasible=res.feasible & keep)

        return solve

    monkeypatch.setattr(solver_planner, "union_program", half)


def _cut_answer_altered(monkeypatch):
    """Each schedule's rows are moved one spot over where the matrix is
    decoded."""
    from k8s_spot_rescheduler_tpu_torch.solver import schedule

    real = schedule.decode_schedule

    def moved(mat):
        return [s._replace(row=s.row + (s.row >= 0)) for s in real(mat)]

    monkeypatch.setattr(schedule, "decode_schedule", moved)


def _repair_unchecked(monkeypatch):
    """Repair's check from scratch passes every candidate lane: a lane
    repair left with pods unplaced, or over a node's room, is proven."""
    from k8s_spot_rescheduler_tpu_torch.solver import repair

    monkeypatch.setattr(repair, "validate_assignment",
                        lambda packed, assign: packed.cand_valid.clone())


FAULTS = {
    "state_unchanged.mirror": (_mirror_keeps_its_state, CELLS),
    "state_unchanged.schedule": (_schedule_never_commits, CELLS),
    "half_the_batch": (_half_the_lanes, CELLS),
    "answer_altered": (_cut_answer_altered, CELLS),
    "repair_unchecked": (_repair_unchecked, CONSTRAINED),
}
CASES = [(f, c) for f, (_, cells) in FAULTS.items() for c in cells]


@pytest.mark.parametrize("fault,name", CASES)
def test_a_planted_fault_comes_out_not_correct(tiny_cell, monkeypatch,
                                               fault, name):
    cell = tiny_cell(name, nodes=40)
    FAULTS[fault][0](monkeypatch)
    res = run_cpu(cell, 17, 1.0)
    assert not res["correct"], (fault, res["checks"])
    assert _off(res) > 0


def _oracle_cut(cluster, dep, ctl):
    """The program's own serial cut (its object-path pack and its numpy
    union and schedule loop), named."""
    from benchmark import feed
    from k8s_spot_rescheduler_tpu_torch.models import cluster as models
    from k8s_spot_rescheduler_tpu_torch.models import tensors
    from k8s_spot_rescheduler_tpu_torch.solver import schedule

    nodes = [feed.node_obj(models, r) for r in cluster.nodes.values()]
    by_node = {n: [feed.pod_obj(models, r) for r in pods.values()]
               for n, pods in cluster.by_node.items()}
    node_map = models.build_node_map(
        nodes, by_node, on_demand_label=dep["on_demand_label"],
        spot_label=dep["spot_label"],
        priority_threshold=ctl["priority_threshold"])
    packed, meta = tensors.pack_cluster(
        node_map, [feed.pdb_obj(models, r) for r in cluster.pdbs],
        resources=tuple(dep["resources"]),
        delete_non_replicated=ctl["delete_non_replicated_pods"])
    mat = schedule.plan_schedule_oracle(
        packed, ctl["schedule_horizon"], best_fit_fallback=True,
        repair_rounds=ctl["repair_rounds"])
    steps = []
    for s in schedule.decode_schedule(mat):
        pods = meta.cand_pods[s.index]
        steps.append(plain.Step(
            meta.candidates[s.index].node.name, s.n_feasible,
            {p.uid: meta.spot[int(s.row[k])].node.name
             for k, p in enumerate(pods)}))
    return ([i.node.name for i in meta.candidates],
            [i.node.name for i in meta.spot], steps)


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
@pytest.mark.parametrize("structure", [0, 1, 2, 3])
def test_the_reference_agrees_with_the_programs_serial_oracle(
        monkeypatch, config, structure):
    """Several clusters (``structure_seed``) of the configuration's
    predicate mix, cut to 30 + 30 nodes: the plain reference's cut
    equals the program's serial one, node by node and pod by pod, with
    repair searching on the constrained mix."""
    searched = []
    real = plain.repair

    def repair(P, pool, lanes, rounds):
        searched.append(len(lanes))
        return real(P, pool, lanes, rounds)

    monkeypatch.setattr(plain, "repair", repair)
    cfg = json.loads((ROOT / f"benchmark/configs/{config}.json").read_text())
    dep = dict(cfg["deployment"], n_on_demand=30, n_spot=30, n_pods=900,
               structure_seed=structure)
    ctl = dict(cfg["controller"], schedule_horizon=12)
    cl = generator.generate_cluster(dep, 2**31 + structure)
    cand, spot, want = _oracle_cut(cl, dep, ctl)
    P, got = plain.solve_cut(cl, dep, ctl, "cpu")
    assert (P.cand_names, P.spot_names) == (cand, spot)
    assert got == want
    assert len(got) >= 1
    assert bool(searched) == (config in {c.split(".")[0] for c in CONSTRAINED})


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_a_cell_on_the_card_is_correct(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", name,
         "--seed", "2147483659", "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"
