"""The harness on the CPU at a tiny size: cells resolved by name, a
configuration added by a file alone, the churn stream, the result line,
and what the harness may import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import generator, harness
from benchmark.tests.conftest import ROOT, run_cpu, tiny_root

BENCH = ROOT / "benchmark"
SPEC = harness.load_spec()
CELLS = [w["name"] for w in SPEC["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = harness.Cell(harness.load_spec(), name)
    assert cell.config_path.is_file() and cell.traffic_path.is_file()
    assert cell.config["name"] == cell.entry["config"]
    assert cell.traffic["call"] == cell.entry["traffic"]
    names = {m["name"] for m in cell.end_to_end + cell.per_layer}
    assert "setup_s" in names
    assert set(cell.readers) == names
    for path in cell.readers.values():
        assert path.parent == BENCH / "metrics"
        assert callable(harness.load_reader(path))


def test_every_metric_lists_cells_that_report_what_it_moves():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= set(CELLS)
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert "workloads" not in moved or cell in moved["workloads"], (
                m["name"], cell)


def test_a_configuration_is_added_by_a_file_alone(tmp_path):
    root = tiny_root(tmp_path)
    spec = json.loads((root / "BENCHMARK.json").read_text())
    base = json.loads((root / spec["configs"][0]["file"]).read_text())
    base["name"] = "throwaway"
    base["deployment"].update(n_on_demand=6, n_spot=6, n_pods=120)
    (root / "benchmark/configs/throwaway.json").write_text(json.dumps(base))
    spec["configs"].append({"name": "throwaway", "source": "a test",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "throwaway.cut", "config": "throwaway",
                              "traffic": "cut", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "cuts_per_s":
            m["workloads"].append("throwaway.cut")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.Cell(harness.load_spec(root), "throwaway.cut", root=root)
    res = run_cpu(cell, 5, 0.5)
    assert res["correct"] and res["attempted"] > 0
    assert set(res["metrics"]) == {"cuts_per_s", "setup_s"}


def _stream(dep, traffic, seed, calls=6):
    cl = generator.generate_cluster(dep, seed)
    churn = generator.Churn(cl, traffic, seed)
    return [churn.step() for _ in range(calls)], cl


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_the_churn_stream_follows_the_seed(tmp_path, config):
    root = tiny_root(tmp_path, nodes=70)
    dep = json.loads((root / f"benchmark/configs/{config}.json").read_text())[
        "deployment"]
    traffic = json.loads((BENCH / "traffic/cut.json").read_text())
    big = 2**31 + 12345
    a, cl_a = _stream(dep, traffic, big)
    b, cl_b = _stream(dep, traffic, big)
    c, _ = _stream(dep, traffic, big + 1)
    assert repr(a) == repr(b)
    assert list(cl_a.pods) == list(cl_b.pods)
    assert repr(a) != repr(c)
    # one cluster, in an order of the seed's
    assert sorted(cl_a.pods) != list(cl_a.pods)
    kinds = {op[0] for ops in a for op in ops}
    assert {"remove_pod", "add_pod"} <= kinds
    assert sum(op[0] == "remove_pod" for op in a[0]) == 100


def test_the_spot_rate_is_the_traffic_files_a_node_a_month():
    dep = {"n_spot": 2500}
    traffic = json.loads((BENCH / "traffic/cut.json").read_text())
    cl = generator.Cluster(dict(dep, spot_label="a=b"))
    churn = generator.Churn(cl, traffic, 1)
    # 20% of 2,500 spot nodes a 30-day month, over one 10 s tick
    assert churn.spot_mean == pytest.approx(0.2 * 2500 * 10 / (30 * 86400))
    assert churn.deletions == churn.creations == 100


def test_the_frozen_generator_draws_the_program_generators_cluster():
    """The copy of io/synthetic.generate_cluster builds the same cluster
    as the original, on the constrained predicate surface."""
    from k8s_spot_rescheduler_tpu_torch.io import synthetic

    dep = json.loads((BENCH / "configs/k8s-1kn-30kp-constrained.json")
                     .read_text())["deployment"]
    dep = dict(dep, n_on_demand=12, n_spot=12, n_pods=300)
    spec = synthetic.SyntheticSpec(
        "t", 12, 12, 300, zipf_sizes=True, taints=True, anti_affinity=True,
        pdbs=True, spread=True, resources=tuple(dep["resources"]))
    for seed in (0, 7, 2**31 + 3):
        fc = synthetic.generate_cluster(spec, seed)
        cl = generator.draw_cluster(dep, seed)
        assert list(fc.nodes) == list(cl.nodes)
        assert [n.taints != [] for n in fc.nodes.values()] == [
            bool(n["taints"]) for n in cl.nodes.values()]
        assert list(fc.pods) == list(cl.pods)
        for uid, pod in fc.pods.items():
            rec = cl.pods[uid]
            assert pod.node_name == rec["node"]
            assert pod.requests == rec["requests"]
            assert pod.anti_affinity_group == rec["anti_affinity_group"]
            assert len(pod.tolerations) == len(rec["tolerations"])
        assert [(p.name, p.disruptions_allowed) for p in fc.pdbs] == [
            (p["name"], p["disruptions_allowed"]) for p in cl.pdbs]


@pytest.mark.parametrize("name", CELLS)
def test_a_tiny_run_is_correct_and_its_line_has_the_keys(tiny_cell, name):
    cell = tiny_cell(name)
    res = run_cpu(cell, 2**31 + 99, 1.0)
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    want = {m["name"] for m in cell.end_to_end}
    assert set(res["metrics"]) == want
    for name_, c in res["checks"].items():
        assert c == {"value": 0, "limit": 0}, name_


@pytest.mark.parametrize("name", CELLS)
def test_a_run_under_many_spot_events_is_correct(tiny_cell, name):
    """Interruptions and replacements, rare at the traffic's rate, at
    several a call: the mirror and the reference follow them alike."""
    cell = tiny_cell(name, nodes=24)
    cell.traffic = dict(cell.traffic, spot_interruptions_per_node_month=2e4)
    res = run_cpu(cell, 2**31 + 7, 1.0)
    assert res["correct"], res["checks"]
    assert res["checks"]["placements_off"]["value"] == 0


def test_a_traced_run_reads_its_per_layer_metrics(tiny_cell):
    cell = tiny_cell(CELLS[-1])
    res = run_cpu(cell, 11, 4.0, trace=True)
    assert res["correct"]
    assert list(res)[-1] == "checks"
    got = set(res["metrics"])
    # spans and the churn; no kernel runs on the CPU, so the device
    # readers that need one find nothing to read
    assert {"mirror_sync_ms.cut", "pack_ms.cut", "upload_ms.cut",
            "schedule_ms.cut"} <= got
    assert "b2_roofline.cut" not in got
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}


def _top_imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".", 1)[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".", 1)[0]


def test_no_module_of_the_harness_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert files
    for path in files:
        for top in _top_imports(path):
            assert top not in harness.FORBIDDEN, (path, top)


def test_the_reference_imports_nothing_of_the_program():
    for path in [BENCH / "reference.py", BENCH / "plain.py",
                 BENCH / "work.py", BENCH / "generator.py"]:
        for top in _top_imports(path):
            assert top != "k8s_spot_rescheduler_tpu_torch", path


def test_a_checkout_of_the_benchmark_alone_prints_no_result(tmp_path):
    """In a directory with only BENCHMARK.json and the benchmark's
    files the run exits non-zero and prints nothing on stdout."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_without_a_card_the_entry_exits_1_and_prints_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(ROOT)})
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 1, proc.stderr
    assert proc.stdout == ""
    assert "cuda" in proc.stderr.lower()


def test_the_reservoir_keeps_a_seeded_uniform_sample():
    from benchmark.reference import Answer, Check

    def kept(seed, n=50, size=3):
        check = Check(seed, size)
        for call in range(n):
            if check.offer(call) is not None:
                check.keep(Answer(call, [], [], []))
        return sorted(check.kept)

    assert kept(4) == kept(4)
    assert len(kept(4)) == 3
    assert len({tuple(kept(s)) for s in range(20)}) > 10
    assert np.mean([np.mean(kept(s)) for s in range(200)]) == pytest.approx(
        24.5, abs=3)
