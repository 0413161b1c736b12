"""The port's bench (``bench/__main__``) past one device's memory, its
watchdog, its error row and ``--solver``, held against the root
``bench.py`` on the CPU.

The latency mode's memory guard (``bench/__main__.latency_program``) runs
beside the root's ``_run_latency`` on the same config, seed and forced
budget (``solver/memory.device_hbm_budget`` patched in both packages):
the root over the first n of the conftest's virtual JAX devices, the port
over ``[cpu] * n``. The row's keys that name the program it ran
(``testing.GUARD_KEYS``; the root's tier read off its ``scale_note``,
``tests/torch_port_fixtures.root_guard_keys``) and the selection vector
must be equal, exactly. The root runs with ``backend_note`` set, which
skips its device-only chain, and plans with ``solver="jax"`` (XLA); the
port with ``solver="torch"``, whose kernels take their plain versions on
the CPU.
"""

from __future__ import annotations

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench_main
from k8s_spot_rescheduler_tpu_torch.bench import protocol
from k8s_spot_rescheduler_tpu_torch.solver import memory as port_memory
from tests.torch_port_fixtures import (
    _root_bench,
    pack_config,
    reference_latency_row,
    root_guard_keys,
    rung_budget,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


def port_row(monkeypatch, config_id: int, n_devices: int, budget: int,
             *flags) -> dict:
    """The port's latency row (``run``, one repeat) over ``[cpu] *
    n_devices`` with ``device_hbm_budget`` forced to ``budget``. Its
    device-only chain (255 solves) is stubbed, as the root's is skipped
    here: neither the guard's keys nor the selection read it."""
    monkeypatch.setattr(port_memory, "device_hbm_budget",
                        lambda device=None: budget)
    monkeypatch.setattr(protocol, "run_protocol",
                        lambda fused, packed: {"device_only_ms": None})
    rc, row = bench_main.run(
        ["--device", "cpu", "--config", str(config_id), "--repeats", "1",
         *flags], devices=[CPU] * n_devices)
    assert rc == 0
    return row


def held_against_the_root(monkeypatch, config_id, n_devices, budget,
                          solver="torch"):
    flags = ("--solver", solver) if solver != "torch" else ()
    got = port_row(monkeypatch, config_id, n_devices, budget, *flags)
    want, want_sel = reference_latency_row(
        config_id, n_devices, budget,
        solver="sharded" if solver == "sharded" else "jax")
    keys = root_guard_keys(want)
    assert {k: got.get(k) for k in testing.GUARD_KEYS} == keys
    assert got["selection"] == want_sel
    assert got["first_candidate"] == want_sel[0]
    assert got["n_feasible"] == want_sel[2]
    # the steady ticks' keys drop out together where the planner's ladder
    # rerouted them, as in the root's row
    for key in ("delta_upload_bytes", "chunks_solved", "repair_chunks"):
        assert (key in got) == (key in want), key
    return got, keys


@pytest.mark.parametrize("solver", ("torch", "sharded"))
def test_one_device_past_the_budget_runs_the_root_program(monkeypatch,
                                                          solver):
    got, keys = held_against_the_root(monkeypatch, 1, 1, 1, solver)
    assert keys["repair_unavailable"] == 1
    assert keys["tier"] == ("single" if solver == "torch" else "2d")
    assert got["solver"] == solver
    assert got["scale_note"].startswith("problem est ")


CONFIG2_RUNGS = ("cand", "cand-chunked", "cand-carry", "2d")


@pytest.mark.parametrize("rung", CONFIG2_RUNGS)
def test_four_devices_past_the_budget_run_the_ladder_rung(monkeypatch, rung):
    budget = rung_budget(rung, pack_config(2), 4)
    got, keys = held_against_the_root(monkeypatch, 2, 4, budget)
    assert keys["tier"] == rung
    assert keys["repair_unavailable"] == int(rung == "2d")
    assert keys["solver"] == ("sharded" if rung == "2d" else "torch")
    if rung == "cand-carry":
        assert keys["carry_chunks"] > 1
    assert rung in got["scale_note"] or "2-D" in got["scale_note"]


def test_four_devices_past_the_budget_under_the_sharded_solver(monkeypatch):
    budget = rung_budget("cand", pack_config(2), 4)
    _, keys = held_against_the_root(monkeypatch, 2, 4, budget, "sharded")
    assert (keys["tier"], keys["repair_unavailable"], keys["solver"]) == (
        "2d", 1, "sharded")


@pytest.mark.parametrize("n_devices", (1, 4))
def test_inside_the_budget_the_row_is_unchanged(monkeypatch, n_devices):
    """A budget above the estimate leaves the program and its row as
    without the guard: the union with repair, "single", no scale_note;
    the selection is the JAX package's fused union's."""
    from k8s_spot_rescheduler_tpu.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu.solver.select import make_fused_planner

    packed = pack_config(1)
    # also above the planner's estimate of its own pack, whose K is padded
    # to max_pods_per_node_hint: its ticks stay on the resident cache
    budget = 100 * port_memory.estimate_union_hbm_bytes(
        *port_memory.packed_shapes(packed))
    got = port_row(monkeypatch, 1, n_devices, budget)
    assert "scale_note" not in got and "solver" not in got
    assert (got["tier"], got["repair_unavailable"], got["carry_chunks"]) == (
        "single", 0, 0)
    assert got["delta_upload_bytes"] > 0
    want = np.asarray(make_fused_planner(union_program(8, True))(packed))
    assert got["selection"] == want.tolist()


@pytest.mark.parametrize("one_device", (True, False))
def test_an_out_of_memory_error_is_annotated_on_one_device(monkeypatch,
                                                           one_device):
    from k8s_spot_rescheduler_tpu_torch.solver import fallback

    def union_program(*args, **kwargs):
        def solve(packed):
            raise torch.OutOfMemoryError("CUDA out of memory.")
        return solve

    monkeypatch.setattr(fallback, "union_program", union_program)
    budget = 1 if one_device else 10**12
    with pytest.raises((RuntimeError, torch.OutOfMemoryError)) as err:
        port_row(monkeypatch, 1, 1, budget)
    text = str(err.value)
    assert text.startswith("CUDA out of memory.")
    assert ("one device, so the mesh tiers cannot engage" in text) == one_device
    assert ("exceeds single-device budget" in text) == one_device


def test_guard_freeze_keys_are_the_ports_at_the_frozen_budgets(monkeypatch):
    """The chip smoke's frozen cases (``data/bench_seed0.json`` "guard"):
    the port's guard, on the frozen pack shapes and budgets, names the
    frozen program. ``latency_program`` builds the program without
    solving it, on the frozen config-3 pack (``data/config3_seed0.npz``)
    and the bench's config-1 pack, so config 3 costs next to nothing
    here."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz

    frozen = testing.load_bench()["guard"]
    assert sorted(frozen) == sorted(c[0] for c in testing.BENCH_GUARD_CASES)
    packs = {3: load_npz(os.path.join(REPO, "k8s_spot_rescheduler_tpu_torch",
                                      "data", "config3_seed0.npz"))[0],
             1: bench_main.build_problem(CONFIGS[1])[0]}
    for tag, case in frozen.items():
        host = packs[case["config"]]
        assert dict(zip("CKSRWA", port_memory.packed_shapes(host))) == (
            case["shape"])
        monkeypatch.setattr(port_memory, "device_hbm_budget",
                            lambda device=None, b=case["budget"]: b)
        program = bench_main.latency_program(
            host, CPU, [CPU] * case["devices"], case["solver"])
        tier = program.tier
        got = {"tier": tier.kind, "carry_chunks": tier.carry_chunks,
               "carry_bytes": tier.carry_bytes,
               "repair_unavailable": int(tier.repair_unavailable),
               "solver": program.solver}
        assert got == case["keys"], tag
        assert program.scale_note == case["scale_note"].replace(
            "single-chip", "single-device"), tag


# --- --solver ----------------------------------------------------------------


@pytest.mark.parametrize("flags", ([], ["--config", "5"], ["--carry-wall"],
                                   ["--chaos"], ["--chain-depth"],
                                   ["--scale-smoke"]),
                         ids=lambda f: " ".join(f) or "latency")
def test_solver_numpy_outside_the_quality_modes_is_an_argument_error(flags):
    with pytest.raises(SystemExit) as err:
        bench_main.parse_args([*flags, "--solver", "numpy"])
    assert err.value.code == 2


@pytest.mark.parametrize("mode", ("--quality", "--quality-boundary",
                                  "--quality-scale"))
def test_solver_numpy_with_the_quality_modes_is_accepted(mode):
    args = bench_main.parse_args([mode, "--solver", "numpy"])
    assert args.solver == "numpy"
    assert bench_main.parse_args([mode]).solver == "torch"


def test_quality_on_the_numpy_oracle_equals_the_root_quality_row(
        monkeypatch, capsys):
    """``--quality --solver numpy`` against the root ``bench.py``'s
    ``--quality`` (whose default is the numpy oracle): ILP, ffd and
    shipped drains a config, and the worst ratio."""
    root = _root_bench()
    rows = []
    monkeypatch.setattr(root, "emit", rows.append)
    assert root.run_quality(0, sweep=1, solver="numpy") == 0
    table = next(ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("quality table"))
    want = ast.literal_eval(table.split(": ", 1)[1])
    rc, row = bench_main.run(["--device", "cpu", "--quality", "--solver",
                              "numpy"])
    assert rc == 0
    assert row["value"] == rows[-1]["value"]
    assert row["metric"] == rows[-1]["metric"]
    got = [(name.split("/")[0], int(name.split("/")[1]), r["ilp"], r["ffd"],
            r["shipped"]) for name, r in row["rows"].items()]
    assert got == [(n, s, ilp, ffd, shipped)
                   for n, s, ilp, ffd, _, shipped, _ in want]
    assert row["backend_attestation"]["solve_backend"] == "numpy"
    assert not any(row["launches"].values())


# --- the watchdog, the error row and the one line ----------------------------


def _python(code: str, timeout: float = 120):
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_watchdog_prints_one_error_row_and_exits_3():
    out = _python("import sys; from k8s_spot_rescheduler_tpu_torch.bench "
                  "import __main__ as b; sys.exit(b.main(['--device', 'cpu', "
                  "'--config', '5', '--watchdog', '1']))")
    assert out.returncode == 3, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert row == {"metric": "replay_replan_ms_p50_1k_events", "value": None,
                   "unit": "ms", "vs_baseline": None,
                   "error": "watchdog: bench exceeded 1s budget"}


def test_a_raising_mode_prints_one_error_row_and_exits_1():
    out = _python(
        "import sys\n"
        "from k8s_spot_rescheduler_tpu_torch.bench import __main__ as b\n"
        "def boom(*args, **kwargs):\n"
        "    raise ValueError('x' * 1000)\n"
        "b.run_latency = boom\n"
        "rc = b.main(['--device', 'cpu', '--config', '1'])\n"
        "b.emit({'metric': 'second'})\n"
        "sys.exit(rc)\n")
    assert out.returncode == 1, out.stderr
    lines = out.stdout.splitlines()
    assert len(lines) == 1, out.stdout
    row = json.loads(lines[0])
    assert row["metric"] == "drain_plan_ms_config1"
    assert row["value"] is None and row["vs_baseline"] is None
    assert len(row["error"]) == 600 and row["error"].endswith("x" * 100 + "\n")
    assert row["backend_attestation"]["solve_backend"] == "cpu"


def test_solver_numpy_on_the_latency_mode_exits_2_without_a_row():
    out = _python("import sys; from k8s_spot_rescheduler_tpu_torch.bench "
                  "import __main__ as b; sys.exit(b.main(['--device', 'cpu', "
                  "'--config', '1', '--solver', 'numpy']))")
    assert out.returncode == 2
    assert out.stdout == ""
    assert "--solver numpy is the host oracle" in out.stderr
