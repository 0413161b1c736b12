"""The port's protocol model (``k8s_spot_rescheduler_tpu_torch/service/
protocol_model.py``) on the CPU, held against the JAX package's model
and bound to the port's own wire, agent and server.

- Every table equals the JAX model's, value by value (the dataclass
  entries by ``dataclasses.astuple``), ``CHECK_BOUNDS`` included, and
  the two modules' syntax trees are equal once their docstrings are
  stripped: only the prose differs.
- The checker (``tools.analysis.proto.model_check.explore``) explores
  the port's ``build_systems()`` and the JAX model's, system by system,
  to the same states, edges, goals, violations, deadlocks and
  undrainable states (the JAX model's pinned sizes, all clean, nothing
  truncated).
- The import-level half of the contract holds on the port's live
  modules: the wire version and kinds, ``agent._Endpoint.__slots__``,
  the numeric ``RemotePlanner`` constants and the jitter intervals they
  span, and the metric registry's shed reasons.
- The model imports only the standard library.
- ``python -m tools.analysis --tier proto k8s_spot_rescheduler_tpu_torch``
  exits 0 with no finding, also with jax and the JAX package made
  unimportable, and its ``protocol-contract`` pass turns red on a copy
  of the port with one seeded drift in its wire, agent or server (and
  stays green on the unchanged copy).
- The port's ``--smoke`` carries the tier: green on the checkout; red,
  with the tier's tail on stderr, on a copy of the checkout with a
  seeded drift; red, saying so, on a copy of the package alone.

Every run of the analyzer is a subprocess from the repository root, as
``tests/test_analysis.py`` runs it.

Tolerance: exact.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import shutil
import subprocess
import sys
from functools import lru_cache
from pathlib import Path

import pytest

from k8s_spot_rescheduler_tpu.service import protocol_model as ref_model
from k8s_spot_rescheduler_tpu_torch.bench import smoke
from k8s_spot_rescheduler_tpu_torch.metrics import registry
from k8s_spot_rescheduler_tpu_torch.service import agent, wire
from k8s_spot_rescheduler_tpu_torch.service import protocol_model as model
from tests.analysis_fixtures import REPO, run_analysis
from tools.analysis.proto.model_check import explore

PACKAGE = "k8s_spot_rescheduler_tpu_torch"
MODEL_PATH = REPO / PACKAGE / "service" / "protocol_model.py"

# the JAX model's pinned explored sizes (tests/test_protocol_model.py)
PINNED = {
    "storm": dict(n_states=91093, n_edges=243145, n_goal=490),
    "version-mix": dict(n_states=3251, n_edges=8459, n_goal=52),
}


def _plain(value):
    """A table as plain data: dataclasses as tuples, containers walked."""
    if dataclasses.is_dataclass(value):
        return ("dataclass", type(value).__name__,
                dataclasses.astuple(value))
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (tuple, list)):
        return type(value)(_plain(v) for v in value)
    return value


# --- (a) the tables ------------------------------------------------------------


TABLES = (
    "VERSIONS", "WIRE_VERSION", "KINDS", "SHED_REASONS", "BREAKER_STATES",
    "BREAKER_TABLE", "BREAKER_CONSTANTS", "ENDPOINT_FIELDS",
    "RETRY_AFTER_INTERVAL_S", "RESYNC_RETRY_DELAY_INTERVAL_S",
    "ADMISSION_CAP_ATTR", "ADMISSION_LOCK_ATTR", "ADMISSION_COUNTERS",
    "ADMISSION_SITES", "LADDER_TABLE", "CHECK_BOUNDS",
)


@pytest.mark.parametrize("name", TABLES)
def test_table_equals_the_jax_model(name):
    got, want = getattr(model, name), getattr(ref_model, name)
    assert type(got) is type(want)
    assert _plain(got) == _plain(want)


def test_every_public_table_is_compared():
    """No table of either model escapes the comparison above."""
    def tables(mod):
        return {k for k, v in vars(mod).items()
                if k.isupper() and not k.startswith("_")
                and not isinstance(v, type)}

    assert tables(model) == tables(ref_model) == set(TABLES)


def _code_only(path: Path) -> str:
    """The module's syntax tree with every docstring taken out."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef))
                and node.body and isinstance(node.body[0], ast.Expr)
                and isinstance(node.body[0].value, ast.Constant)
                and isinstance(node.body[0].value.value, str)):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_only_the_prose_differs_from_the_jax_model():
    assert MODEL_PATH.read_text() != Path(ref_model.__file__).read_text()
    assert _code_only(MODEL_PATH) == _code_only(Path(ref_model.__file__))


# --- (b) the exploration -------------------------------------------------------


@lru_cache(maxsize=None)
def _explored(mod):
    return {s.name: explore(s) for s in mod.build_systems()}


def _outcome(result):
    return dict(n_states=result.n_states, n_edges=result.n_edges,
                n_goal=result.n_goal, truncated=result.truncated,
                violations=result.violations, deadlocks=result.deadlocks,
                undrainable=result.undrainable)


@pytest.mark.parametrize("name", sorted(PINNED))
def test_exploration_matches_the_jax_model_and_is_clean(name):
    results, want = _explored(model), _explored(ref_model)
    assert set(results) == set(want) == set(PINNED)
    result = results[name]
    assert _outcome(result) == _outcome(want[name])
    assert dict(n_states=result.n_states, n_edges=result.n_edges,
                n_goal=result.n_goal) == PINNED[name]
    assert not result.truncated
    assert result.violations == []
    assert result.deadlocks == []
    assert result.undrainable == []


def test_systems_run_the_port_models_own_bounds():
    systems = model.build_systems()
    assert [s.bounds for s in systems] == list(model.CHECK_BOUNDS)
    assert all(type(s) is model.ProtocolSystem for s in systems)


# --- (c) the import-level contract ---------------------------------------------


def test_wire_versions_and_kinds_equal_the_live_wire():
    assert model.WIRE_VERSION == wire.WIRE_VERSION
    assert tuple(model.VERSIONS) == tuple(wire.SUPPORTED_VERSIONS)
    live = {k: v for k, v in vars(wire).items()
            if k.startswith("KIND_") and isinstance(v, int)}
    assert live == {k: kind.value for k, kind in model.KINDS.items()}


def test_endpoint_slots_equal_endpoint_fields():
    assert agent._Endpoint.__slots__ == model.ENDPOINT_FIELDS
    assert agent.Endpoint is agent._Endpoint


def test_breaker_constants_equal_remote_planner():
    live = {k: v for k, v in vars(agent.RemotePlanner).items()
            if k.isupper() and isinstance(v, (int, float))
            and not isinstance(v, bool)}
    assert live == model.BREAKER_CONSTANTS
    rp = agent.RemotePlanner
    assert model.RETRY_AFTER_INTERVAL_S == (
        0.0, rp.RETRY_AFTER_CAP_S * (1.0 + rp.RETRY_JITTER_FRAC))
    assert model.RESYNC_RETRY_DELAY_INTERVAL_S == (0.0, rp.RESYNC_JITTER_S)


def test_shed_reasons_equal_the_metric_registry():
    assert set(registry.SHED_REASONS) == set(model.SHED_REASONS)


# --- (d) the model imports only the standard library ---------------------------


def test_model_imports_only_the_standard_library():
    tree = ast.parse(MODEL_PATH.read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, "relative import in the model"
            roots.add(node.module.split(".")[0])
    assert roots, "the model imports nothing at all"
    assert roots <= set(sys.stdlib_module_names), roots


# --- (e) the proto tier over the port ------------------------------------------


def test_proto_tier_is_green_on_the_port():
    r = run_analysis("--tier", "proto", PACKAGE)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "protocol-" not in r.stdout


# the tier as the card's host runs it: no jax, no JAX package
JAX_FREE_TIER = """
import runpy, sys
for name in ("jax", "jaxlib", "k8s_spot_rescheduler_tpu"):
    sys.modules[name] = None  # an import of any of them now raises
sys.argv = ["tools.analysis", "--tier", "proto", sys.argv[1]]
runpy.run_module("tools.analysis", run_name="__main__")
"""


def test_proto_tier_runs_without_jax():
    r = subprocess.run([sys.executable, "-c", JAX_FREE_TIER, PACKAGE],
                       capture_output=True, text=True, cwd=REPO)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "protocol-" not in r.stdout


# --- (f) seeded drift on a copy of the port ------------------------------------


def _ignore(directory, names):
    return [n for n in names if n in ("__pycache__", "data")
            or not n.endswith(".py") and not (Path(directory) / n).is_dir()]


def _copy_port(tmp_path) -> Path:
    """The port's .py files under ``tmp_path``, in its own layout."""
    dst = tmp_path / PACKAGE
    shutil.copytree(REPO / PACKAGE, dst, ignore=_ignore)
    return dst


def _sub(old: str, new: str, count: int = 1):
    def edit(src: str) -> str:
        assert old in src, f"{old!r} is not in the file: the seed is void"
        return src.replace(old, new, count)

    return edit


def _append(text: str):
    return lambda src: src + text


def _contract(root: Path):
    return run_analysis(root, "--tier", "proto", "--pass",
                        "protocol-contract", "--no-baseline")


# case: (file under service/, edit, text of the finding it must raise)
DRIFTS = {
    "new-remote-planner-constant": (
        "agent.py",
        _sub("    FAIL_THRESHOLD = 2\n",
             "    FAIL_THRESHOLD = 2\n    PROBE_LIMIT = 3\n"),
        "live RemotePlanner constant PROBE_LIMIT=3 is absent from the "
        "protocol model's BREAKER_CONSTANTS"),
    "changed-fail-threshold": (
        "agent.py",
        _sub("    FAIL_THRESHOLD = 2\n", "    FAIL_THRESHOLD = 3\n"),
        "RemotePlanner.FAIL_THRESHOLD is 3 live but 2 in the protocol "
        "model"),
    "renamed-resync-retry-delay": (
        "agent.py", _sub("_resync_retry_delay", "_resync_backoff", -1),
        "model site 'service/agent.py::RemotePlanner._resync_retry_delay' "
        "maps to no live function"),
    "new-wire-kind": (
        "wire.py", _sub("KIND_RESYNC = 6", "KIND_PING = 7\nKIND_RESYNC = 6"),
        "live wire frame kind KIND_PING=7 is absent from the protocol "
        "model's KINDS table"),
    "new-admission-attribute": (
        "server.py",
        _sub("        self._resync_pressure = 0\n",
             "        self._resync_pressure = 0\n"
             "        self._resync_budget_left = 0\n"),
        "live admission attribute self._resync_budget_left is absent from "
        "the protocol model"),
    "renamed-note-resync": (
        "server.py", _sub("note_resync", "record_resync", -1),
        "model site 'service/server.py::PlannerService.note_resync' maps "
        "to no live function"),
    "new-shed-reason": (
        "server.py",
        _append("\n\ndef _seeded_shed(service):\n"
                "    service._note_shed(\"rate-limit\", \"seeded\", "
                "tenant=\"t\")\n"),
        "live _note_shed reason 'rate-limit' is absent from the protocol "
        "model's SHED_REASONS table"),
    "extra-endpoint-slot": (
        "agent.py",
        _sub('"skip_until", "acked_fp")',
             '"skip_until", "acked_fp",\n                 "probe_at")'),
        "_Endpoint.__slots__ is ('url', 'consecutive_failures', "
        "'skip_until', 'acked_fp', 'probe_at') live but the protocol "
        "model's ENDPOINT_FIELDS"),
}


def _drift(root: Path, rel: str, edit) -> None:
    f = root / "service" / rel
    f.write_text(edit(f.read_text()))


def test_unchanged_copy_of_the_port_is_green(tmp_path):
    r = _contract(_copy_port(tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "protocol-contract" not in r.stdout


@pytest.mark.parametrize("case", sorted(DRIFTS))
def test_seeded_drift_turns_the_contract_red(tmp_path, case):
    rel, edit, finding = DRIFTS[case]
    root = _copy_port(tmp_path)
    _drift(root, rel, edit)
    r = _contract(root)
    assert r.returncode == 1, r.stdout + r.stderr
    assert finding in r.stdout, r.stdout


# --- the --smoke row -----------------------------------------------------------


def _copy_checkout(tmp_path, with_tools: bool) -> Path:
    """The port (and the analyzer, ``with_tools``) under ``tmp_path``,
    laid out as in the checkout."""
    _copy_port(tmp_path)
    if with_tools:
        shutil.copytree(REPO / "tools", tmp_path / "tools",
                        ignore=shutil.ignore_patterns("__pycache__"))
    return tmp_path


def _bench_smoke(root: Path):
    return subprocess.run(
        [sys.executable, "-m", f"{PACKAGE}.bench", "--device", "cpu",
         "--smoke"], capture_output=True, text=True, cwd=root)


def test_smoke_verify_protocol_is_green_on_the_checkout():
    ok, wall_ms = smoke.verify_protocol()
    assert ok and wall_ms > 0
    assert smoke.PROTO_TIER[-1] == PACKAGE
    assert smoke.ROOT == REPO


def test_smoke_fails_on_a_drifted_copy_and_prints_the_tail(tmp_path):
    root = _copy_checkout(tmp_path, with_tools=True)
    _drift(root / PACKAGE, *DRIFTS["changed-fail-threshold"][:2])
    r = _bench_smoke(root)
    assert r.returncode == 1, r.stdout + r.stderr
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert row["ok"] is False and row["verify_protocol_ms"] > 0
    assert "bench-smoke: protocol verification RED (rc=1)" in r.stderr
    assert "RemotePlanner.FAIL_THRESHOLD is 3 live but 2" in r.stderr


def test_smoke_outside_a_checkout_says_so_and_fails(tmp_path):
    root = _copy_checkout(tmp_path, with_tools=False)
    r = _bench_smoke(root)
    assert r.returncode == 1, r.stdout + r.stderr
    row = json.loads(r.stdout.strip().splitlines()[-1])
    assert row["ok"] is False and row["verify_protocol_ms"] == 0.0
    assert "is not a checkout of the repository" in r.stderr
