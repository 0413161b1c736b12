"""One run of one cell: set-up, the measured window, the trace, the check.

Everything a cell needs is found by name from ``BENCHMARK.json``: its
configuration file (``configs/<config>.json``), its traffic mix
(``traffic/<traffic>.json``) and a reader a metric
(``metrics/<name>.py``, else ``metrics/<name up to its first dot>.py``),
so a cell, a mix or a metric is added by files and entries alone.

The window drives the program's Planner surface on its columnar mirror
as the controller's loop calls it (``loop/controller.Rescheduler.
_next_plan``), in a closed loop with one caller and the housekeeping
interval compressed to zero: before each call the harness draws one
call's churn (``generator.Churn``) and hands it to the simulated API
server, whose hooks update the mirror; then it cuts a drain schedule
(``plan_schedule``). No plan is actuated. The draw is the load
generator's work, not the program's: its time is kept out of the
window.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import os
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "k8s_spot_rescheduler_tpu")


class BenchError(Exception):
    """A run that cannot produce a result (no card, a missing file)."""


def process_start_epoch() -> float:
    """Wall time this process started, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start_ticks = int(fields[19])  # field 22 of stat(5)
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    return time.time() - age


# ---------------------------------------------------------------------------
# resolving a cell by name


def load_spec(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise BenchError(f"{path} is missing")
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_reader(name: str, bench: Path = BENCH) -> Path:
    """``metrics/<name>.py``, else ``metrics/<name up to its first
    dot>.py`` (one reader serving ``x.cut`` and a later ``x.<kind>``)."""
    for stem in (name, name.split(".", 1)[0]):
        path = bench / "metrics" / f"{stem}.py"
        if path.is_file():
            return path
    raise BenchError(f"no reader for metric {name!r} under {bench / 'metrics'}")


def load_reader(path: Path):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Cell:
    """A workload of ``BENCHMARK.json`` with its files resolved."""

    def __init__(self, spec: dict, name: str, root: Path = ROOT,
                 bench: Path = BENCH):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise BenchError(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        configs = {c["name"]: c for c in spec["configs"]}
        cfg_entry = configs[self.entry["config"]]
        self.config_path = root / cfg_entry["file"]
        self.traffic_path = bench / "traffic" / f"{self.entry['traffic']}.json"
        for path in (self.config_path, self.traffic_path):
            if not path.is_file():
                raise BenchError(f"{path} is missing")
        with open(self.config_path) as f:
            self.config = json.load(f)
        with open(self.traffic_path) as f:
            self.traffic = json.load(f)
        self.chips = int(self.entry["chips"])
        self.end_to_end = [m for m in spec["end_to_end"] if _applies(m, name)]
        self.per_layer = [m for m in spec["per_layer"] if _applies(m, name)]
        self.readers = {m["name"]: find_reader(m["name"], bench)
                        for m in self.end_to_end + self.per_layer}


# ---------------------------------------------------------------------------
# what a run measured, for the readers


class RunRecord:
    """The readers' input. ``kind`` is the traffic's call ("cut"); per
    call of the window ``latency_s`` and ``sync_s`` (the churn handed to
    the program); ``spans`` per traced, unprofiled call {span name: ms};
    ``device`` the reduced device trace (``devtrace.Reduced``) of the
    profiled calls and ``profiled`` their count; ``b2`` (bound s, device
    s) of those calls' best-fit launches, or None. ``window_s`` leaves
    out the churn's draw."""

    def __init__(self, kind: str):
        self.kind = kind
        self.setup_s = 0.0
        self.window_s = 0.0
        self.latency_s: List[float] = []
        self.sync_s: List[float] = []
        self.spans: List[Dict[str, float]] = []
        self.device = None
        self.profiled = 0
        self.b2 = None

    def mean_span(self, metric: str, span: str) -> Optional[float]:
        """Mean ms a call of ``span`` over the traced, unprofiled calls,
        where ``metric``'s suffix (``x.cut``) is this run's kind."""
        if metric.split(".", 1)[-1] != self.kind or not self.spans:
            return None
        return sum(s.get(span, 0.0) for s in self.spans) / len(self.spans)


def _flat_spans(trace, t0: float) -> List[tuple]:
    """(name, start, end, depth) of every span of ``trace`` on
    perf_counter, ``t0`` being the trace's start."""
    out = []
    stack = [(sp, 0) for sp in trace.spans]
    while stack:
        sp, depth = stack.pop()
        start = t0 + sp.t0_ms / 1e3
        out.append((sp.name, start, start + sp.dur_ms / 1e3, depth))
        stack.extend((c, depth + 1) for c in sp.children)
    return out


def _span_ms(flat) -> Dict[str, float]:
    ms: Dict[str, float] = {}
    for name, a, b, _ in flat:
        ms[name] = ms.get(name, 0.0) + (b - a) * 1e3
    return ms


# ---------------------------------------------------------------------------
# the run


def controller_config(cell: Cell):
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    dep = cell.config["deployment"]
    return ReschedulerConfig(
        resources=tuple(dep["resources"]),
        on_demand_node_label=dep["on_demand_label"],
        spot_node_label=dep["spot_label"],
        **cell.config["controller"],
    )


def _b2_launches(horizon: int, steps, launched: int):
    """The best-fit launches of one cut, each as the lanes drained before
    it, or None when they disagree with the trace's count of launches
    (``launched``): one a step, and one more for the probe that ended a
    cut short of the horizon."""
    n = len(steps)
    expect = n + 1 if n < horizon else horizon
    if expect != launched:
        return None
    drained = [s.index for s in steps]
    return [drained[:k] for k in range(expect)]


def _card() -> str:
    """``nvidia-smi``'s name and power limit of the card, or why not."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"not read ({err})"
    return proc.stdout.strip() or f"not read (exit {proc.returncode})"


def run(cell: Cell, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", t_start: Optional[float] = None,
        control: bool = False, log=sys.stderr) -> dict:
    """One run; returns the result line's object. ``control`` checks
    the reference with its taint guarantee broken in the program's
    place (``reference.Check.run``) instead of the program's answers."""
    import torch

    from benchmark import devtrace, feed, generator, work
    from benchmark.reference import LIMITS, Answer, Check

    t_start = process_start_epoch() if t_start is None else t_start
    if device == "cuda":
        if not torch.cuda.is_available():
            raise BenchError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < cell.chips:
            raise BenchError(f"{torch.cuda.device_count()} card(s), the cell "
                             f"asks for {cell.chips}")
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils import tracing

    dep, traffic = cell.config["deployment"], cell.traffic
    kind = traffic["call"]
    if kind != "cut":
        raise BenchError(f"traffic call {kind!r}: the harness drives cuts")
    ctl = cell.config["controller"]
    rec = RunRecord(kind)

    # ---- set-up: the cluster, the mirror, the planner, the warm-up
    cluster = generator.generate_cluster(dep, seed)
    fc = feed.fake_cluster(cluster)
    cfg = controller_config(cell)
    store = fc.columnar_store(cfg.resources,
                              on_demand_label=cfg.on_demand_node_label,
                              spot_label=cfg.spot_node_label)
    dev = torch.device(device)
    planner = TorchSolverPlanner(cfg, device=dev, devices=[dev])
    pdbs = fc.list_pdbs()
    warm = []
    for _ in range(int(traffic["warmup_calls"])):
        t_w = time.perf_counter()
        if planner.plan_schedule(store, pdbs) is None:
            raise BenchError("the warm-up call returned no schedule")
        warm.append(time.perf_counter() - t_w)
    prof = None
    n_prof = int(traffic["trace_calls"]) if trace else 0
    if trace:
        # the profiler's first start pays for its own set-up
        prof = devtrace.Profiler()
        prof.start()
        torch.zeros(1, device=dev).add_(1)
        prof.end()
        prof = devtrace.Profiler()
    churn = generator.Churn(cluster, traffic, seed)
    check = Check(seed, int(traffic["check_calls"]))
    # set-up's objects (the cluster, its mirror) move to the permanent
    # generation: the window's collections do not walk them again
    gc.collect()
    gc.freeze()
    if device == "cuda":
        torch.cuda.synchronize()

    # ---- the window, its clock stopped while the churn is drawn
    failed = 0
    windows: Dict[int, tuple] = {}
    flat: Dict[int, list] = {}
    prof_out: Dict[int, tuple] = {}
    drawn = 0.0
    draws: List[tuple] = []
    t_win0 = time.perf_counter()
    rec.setup_s = time.time() - t_start
    t_end = t_win0
    call = 0
    while time.perf_counter() - t_win0 - drawn < seconds:
        profiled = call < n_prof
        t_d = time.perf_counter()
        ops = churn.step()
        t_c0 = time.perf_counter()
        drawn += t_c0 - t_d
        if 0 < call < n_prof:
            draws.append((t_d, t_c0))
        if profiled and call == 0:
            prof.start()
        feed.apply(fc, ops)
        t_c1 = time.perf_counter()
        tctx = tracing.tick_trace() if trace else contextlib.nullcontext()
        mctx = prof.mark(call) if profiled else contextlib.nullcontext()
        out = None
        with tctx as tr, mctx:
            t_a = time.perf_counter()
            try:
                out = planner.plan_schedule(store, pdbs)
            except Exception:  # noqa: BLE001 — a failed call is counted, and the run goes on
                traceback.print_exc(file=log)
            t_b = time.perf_counter()
        t_end = t_b
        rec.latency_s.append(t_b - t_a)
        rec.sync_s.append(t_c1 - t_c0)
        if out is None:
            failed += 1
        elif check.offer(call) is not None:
            check.keep(Answer.of(call, out))
        if trace and tr is not None:
            spans = _flat_spans(tr, t_a)
            if profiled:
                windows[call] = (t_c0, t_a, t_b)
                flat[call] = spans
                if out is not None:
                    prof_out[call] = (planner.last_packed, out.steps)
            else:
                rec.spans.append(_span_ms(spans))
        call += 1
        if profiled and call == n_prof:
            prof.end()
    rec.window_s = t_end - t_win0 - drawn
    if 0 < call < n_prof:  # the window ended before the traced calls did
        prof.end()

    # ---- after the window: peak, trace, free the program, check
    peak = torch.cuda.max_memory_allocated(dev) if device == "cuda" else 0
    if trace and windows:
        prof.read()
        t0 = min(w[0] for w in windows.values())
        t1 = max(w[2] for w in windows.values())
        red = devtrace.reduce(prof.events, prof.marks, windows, flat, t0, t1,
                              draws)
        prof.events = None
        rec.device, rec.profiled = red, len(windows)
        bound = spent = 0.0
        for c, (pack, steps) in prof_out.items():
            b2 = [d for name, d in red.per_call.get(c, ()) if "greedy_kernel<true" in name]
            launches = _b2_launches(ctl["schedule_horizon"], steps, len(b2))
            if launches is None:
                print(f"b2: call {c}: launches disagree with the trace; "
                      "left out of the roofline", file=log)
                continue
            bound += work.b2_bound_s(pack, launches)
            spent += sum(b2) / 1e6
        rec.b2 = (bound, spent) if spent > 0 else None
        prof_out.clear()
        print(f"card (the roofline's peaks are at 700 W): {_card()}", file=log)
    del planner, store, fc, prof_out
    gc.unfreeze()
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(cell.readers[m["name"]])(rec, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    def replay(wanted):
        cl = generator.generate_cluster(dep, seed)
        ch = generator.Churn(cl, traffic, seed)
        pending = list(wanted)
        i = 0
        while pending:
            ch.step()
            if i == pending[0]:
                pending.pop(0)
                yield i, cl
            i += 1

    t_ref = time.perf_counter()
    totals = check.run(dep, ctl, dev, replay, control=control)
    print(f"reference: {totals['calls_checked']} call(s) checked in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log)
    checks = {name: {"value": totals[name], "limit": LIMITS[name]}
              for name in LIMITS}
    correct = (failed == 0 and totals["calls_checked"] > 0
               and all(c["value"] <= c["limit"] for c in checks.values()))

    found = sorted(m for m in sys.modules if m.split(".", 1)[0] in FORBIDDEN)
    if found:
        raise BenchError(f"modules loaded that the run may not load: {found}")

    devinfo = {"platform": "gpu" if device == "cuda" else device,
               "kind": (torch.cuda.get_device_name(dev) if device == "cuda"
                        else "cpu"),
               "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": call, "failed": failed,
              "metrics": metrics, "device": devinfo}
    if trace and rec.device is not None:
        devinfo["busy_s"] = rec.device.busy_s
        devinfo["window_s"] = rec.device.window_s
        result["breakdown"] = {
            "device_ops": sorted(([n[:120], s] for n, s in rec.device.ops.items()),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(([n, s] for n, s in rec.device.idle.items()),
                                key=lambda x: -x[1])[:10],
        }
    lat = np.asarray(rec.latency_s) * 1e3
    print("warm-up calls ms: " + ", ".join(f"{1e3 * w:.3f}" for w in warm)
          + "; the window's first calls ms: "
          + ", ".join(f"{x:.3f}" for x in lat[:5]), file=log)
    if lat.size:
        print(f"calls {call}, failed {failed}, window {rec.window_s:.3f} s "
              f"(churn drawn {drawn:.3f} s, left out), set-up "
              f"{rec.setup_s:.3f} s; latency ms: median "
              f"{np.median(lat):.3f}, p95 {np.percentile(lat, 95):.3f}, min "
              f"{lat.min():.3f}, max {lat.max():.3f}, first {lat[0]:.3f}, "
              f"first half {np.median(lat[:lat.size // 2 + 1]):.3f}, last half "
              f"{np.median(lat[lat.size // 2:]):.3f}; churn into the mirror "
              f"ms a call {1e3 * float(np.mean(rec.sync_s)):.3f}", file=log)
    for name, c in checks.items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=log)
    result["checks"] = checks
    return result
