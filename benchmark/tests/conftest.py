"""Helpers of the benchmark's CPU tests: cells of ``BENCHMARK.json`` cut
to a tiny cluster in a temporary checkout root (the configuration files
rewritten there; traffic and readers from this benchmark)."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402


def tiny_root(tmp_path: Path, nodes: int = 16) -> Path:
    """A root holding ``BENCHMARK.json`` and every configuration cut to
    ``nodes`` on-demand and ``nodes`` spot nodes, 30 pods a node."""
    spec = harness.load_spec()
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    for c in spec["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        dep = cfg["deployment"]
        dep["n_on_demand"] = dep["n_spot"] = nodes
        dep["n_pods"] = 30 * nodes
        path = tmp_path / c["file"]
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(cfg))
    return tmp_path


@pytest.fixture
def tiny_cell(tmp_path):
    def make(name: str, nodes: int = 16) -> harness.Cell:
        root = tiny_root(tmp_path, nodes)
        return harness.Cell(harness.load_spec(root), name, root=root)

    return make


def run_cpu(cell, seed: int, seconds: float = 1.0, trace: bool = False,
            **kw) -> dict:
    return harness.run(cell, seed, seconds, trace, device="cpu", **kw)
