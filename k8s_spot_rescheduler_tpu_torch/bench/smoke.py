"""``--smoke`` and ``--pallas-smoke``: the root ``bench.py``'s two CI
smokes, on the port's planner and kernels.

``--smoke`` (the reference's ``run_smoke``): a small cluster (config 2
cut to 64 on-demand and 64 spot nodes, 600 pods) runs five ticks of the
incremental pipeline (``bench/__main__.run_incremental_ticks``, churn 3,
16-lane staged chunks) on ``device``. It fails unless the steady delta
tick uploads fewer bytes than the first full pack and does not repack.
The row reports the span medians of the steady ticks, and
``verify_protocol_ms``, the reference's key: the wall clock of a fresh
subprocess, ``python -m tools.analysis --tier proto
k8s_spot_rescheduler_tpu_torch`` from the checkout's root, which
explores this package's protocol model (``service/protocol_model.py``)
exhaustively and binds it to this package's wire, agent and server. A
red verification prints the tail of its output on stderr and fails the
smoke, as does a run past ``PROTO_TIMEOUT_S`` or a package that does not
sit in a checkout of the repository: ``tools/`` ships with the checkout,
not with this package, so an installed copy's ``--smoke`` says so and
fails. The reference's other subprocess key, ``audit_jaxpr_ms``, stays
out: the jaxpr tier audits programs that JAX traces, and this package
has none. Nothing in this package imports ``tools``; only the
subprocess runs it.

``--pallas-smoke`` (the reference's ``pallas_parity_smoke``, metric
name kept): on a real observe-path pack plus two spot permutations of
it with jittered free capacity (the same rng draws), kernel B4
(``plan_stream_bf_kernel``) must equal the plain streamed best-fit
(``solver/ffd.plan_ffd_streamed(best_fit=True)``) at every chunk count
of ``chunk_counts`` and the best-fit oracle, and B1 the first-fit
oracle (``solver/numpy_oracle``), feasible masks and assignments bit
for bit. On CPU tensors the wrappers take their plain versions, so
``--device cpu`` checks the plain versions only; the row's ``kernels``
lists what launched (empty there).
"""

from __future__ import annotations

import dataclasses
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SPAN_FIELDS = (("span_queue_ms", "service.queue-wait"),
               ("span_solve_ms", "plan.solve"),
               ("span_wire_ms", "wire.transfer"))
CHUNK_COUNTS = (2, 3, 5)
# the checkout's root, which holds tools/ beside this package
ROOT = Path(__file__).resolve().parents[2]
PROTO_TIER = ("-m", "tools.analysis", "--tier", "proto",
              "k8s_spot_rescheduler_tpu_torch")
PROTO_TIMEOUT_S = 120.0


def span_ms_median(traces, name: str) -> float:
    """Median per-tick total of the spans called ``name`` (0.0 for a
    tick where it never fired, e.g. queue and wire spans in process)."""
    totals = []
    for trace in traces:
        if trace is None:
            continue
        spans = trace.find(name)
        totals.append(sum(s.dur_ms for s in spans) if spans else 0.0)
    return float(np.median(totals)) if totals else 0.0


def verify_protocol() -> tuple:
    """Run the proto tier over this package in a fresh subprocess from
    the checkout's root; returns (green, wall ms). A red, timed-out or
    impossible run says why on stderr."""
    if not (ROOT / "tools" / "analysis" / "__main__.py").is_file():
        print(f"bench-smoke: protocol verification cannot run: {ROOT} is "
              f"not a checkout of the repository (no tools/analysis)",
              file=sys.stderr)
        return False, 0.0
    t0 = time.perf_counter()
    try:
        proc = subprocess.run([sys.executable, *PROTO_TIER],
                              capture_output=True, text=True, cwd=ROOT,
                              timeout=PROTO_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        print(f"bench-smoke: protocol verification timed out after "
              f"{PROTO_TIMEOUT_S:.0f} s", file=sys.stderr)
        return False, (time.perf_counter() - t0) * 1e3
    wall_ms = (time.perf_counter() - t0) * 1e3
    if proc.returncode != 0:
        print(f"bench-smoke: protocol verification RED "
              f"(rc={proc.returncode}):\n{proc.stdout[-2000:]}\n"
              f"{proc.stderr[-2000:]}", file=sys.stderr)
    return proc.returncode == 0, wall_ms


def smoke_spec():
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS

    return dataclasses.replace(CONFIGS[2], name="bench-smoke",
                               n_on_demand=64, n_spot=64, n_pods=600)


def run_smoke(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import (
        build_problem,
        progress,
        run_incremental_ticks,
    )

    spec = smoke_spec()
    _, pack_s, _, client, store, pdbs = build_problem(spec, args.seed)
    tick_ms, reports, sync_ms, traces = run_incremental_ticks(
        client, store, pdbs, spec, device,
        n_ticks=5, churn=3, staged_chunk_lanes=16,
    )
    report = reports[-1]
    uploads = [int(r.upload_bytes) for r in reports]
    ok = (
        uploads[-1] < uploads[0]
        and not report.full_repack
        and report.delta_pack_lanes >= 0
        and report.chunks_solved >= 0
    )
    proto_ok, verify_protocol_ms = verify_protocol()
    ok = ok and proto_ok
    progress(f"bench-smoke: uploads per tick {uploads} B  tick ms "
             f"{[round(t, 1) for t in tick_ms]}  chunks "
             f"{report.chunks_solved} solved / {report.chunks_skipped} "
             f"skipped  -> {'OK' if ok else 'FAIL'}")
    row = {
        "metric": metric,
        "value": uploads[-1],
        "unit": unit,
        "vs_baseline": round(uploads[0] / max(uploads[-1], 1), 2),
        "first_full_pack_bytes": uploads[0],
        "delta_upload_bytes": uploads[-1],
        "upload_bytes": uploads,
        "delta_pack_lanes": int(report.delta_pack_lanes),
        "chunks_solved": int(report.chunks_solved),
        "chunks_skipped": int(report.chunks_skipped),
        "steady_tick_ms": round(float(np.median(tick_ms[1:])), 3),
        "sync_ms": round(float(np.median(sync_ms)), 3),
        "pack_ms": round(pack_s * 1e3, 3),
        **{key: round(span_ms_median(traces[1:], name), 3)
           for key, name in SPAN_FIELDS},
        "verify_protocol_ms": round(verify_protocol_ms, 1),
        "ok": ok,
    }
    return (0 if ok else 1), row


def parity_cases(seed: int = 0) -> list:
    """The reference's three parity packs (host): the observe-path pack
    of config 2 cut to 6 on-demand and 10 spot nodes with 64 pods, then
    two permutations of its spot axis (every spot plane together) with
    the free capacity jittered, the same rng draws."""
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    spec = dataclasses.replace(CONFIGS[2], name="pallas-parity",
                               n_on_demand=6, n_spot=10, n_pods=64)
    cfg = ReschedulerConfig(resources=spec.resources)
    client = generate_cluster(spec, seed)
    store = client.columnar_store(
        cfg.resources,
        on_demand_label=cfg.on_demand_node_label,
        spot_label=cfg.spot_node_label,
    )
    packed, _ = store.pack(client.list_pdbs(),
                           priority_threshold=cfg.priority_threshold)
    rng = np.random.default_rng(seed)
    cases = [packed]
    S = int(np.asarray(packed.spot_free).shape[0])
    for _ in range(2):
        perm = rng.permutation(S)
        cases.append(packed._replace(
            spot_free=np.asarray(packed.spot_free)[perm]
            * rng.uniform(0.5, 1.5, (S, 1)).astype(np.float32),
            spot_count=np.asarray(packed.spot_count)[perm],
            spot_max_pods=np.asarray(packed.spot_max_pods)[perm],
            spot_taints=np.asarray(packed.spot_taints)[perm],
            spot_ok=np.asarray(packed.spot_ok)[perm],
            spot_aff=np.asarray(packed.spot_aff)[perm],
        ))
    return cases


def pallas_parity_smoke(device, seed: int = 0,
                        chunk_counts=CHUNK_COUNTS) -> dict:
    """B4 against the plain streamed best-fit at ``chunk_counts`` and
    the best-fit oracle, and B1 against the first-fit oracle, on
    ``parity_cases(seed)`` moved to ``device``. Returns the check
    counts, the mismatches (case, versus what) and the wall seconds."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.ops.ffd_kernels import (
        plan_ffd_kernel,
        plan_stream_bf_kernel,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd_streamed
    from k8s_spot_rescheduler_tpu_torch.solver.numpy_oracle import plan_oracle

    cases = parity_cases(seed)
    mismatches = []

    def check(tag, case_i, got, want):
        if not (
            np.array_equal(_host(got.feasible), _host(want.feasible))
            and np.array_equal(_host(got.assignment),
                               _host(want.assignment))
        ):
            mismatches.append({"case": case_i, "vs": tag})

    t0 = time.perf_counter()
    for i, pk in enumerate(cases):
        lay = carry_layout(pk)
        dev = to_device(pk, device)
        got = plan_stream_bf_kernel(dev, layout=lay)
        check("oracle-bf", i, got, plan_oracle(pk, best_fit=True))
        for n in chunk_counts:
            check(f"stream-c{n}", i, got,
                  plan_ffd_streamed(dev, carry_chunks=n, layout=lay,
                                    best_fit=True))
        check("oracle-ff", i, plan_ffd_kernel(dev), plan_oracle(pk))
    return {
        "ok": not mismatches,
        "cases": len(cases),
        "chunk_counts": list(chunk_counts),
        "checks": len(cases) * (len(chunk_counts) + 2),
        "mismatches": mismatches,
        "wall_s": round(time.perf_counter() - t0, 3),
    }


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def run_pallas_smoke(args, device, metric: str, unit: str) -> tuple:
    from k8s_spot_rescheduler_tpu_torch.bench.__main__ import progress
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels

    before = dict(ffd_kernels.LAUNCHES)
    result = pallas_parity_smoke(device, seed=args.seed)
    kernels = sorted(k for k, v in ffd_kernels.LAUNCHES.items()
                     if v > before.get(k, 0))
    launched = ", ".join(kernels) or "none (plain versions)"
    progress(f"pallas-smoke: {result['cases']} packs x chunk counts "
             f"{result['chunk_counts']} ({result['checks']} parity checks) "
             f"in {result['wall_s']}s on {device}, kernels {launched} -> "
             f"{'OK' if result['ok'] else 'FAIL: %s' % result['mismatches']}")
    return (0 if result["ok"] else 1), {
        "metric": metric,
        "value": result["wall_s"],
        "unit": unit,
        "cases": result["cases"],
        "checks": result["checks"],
        "chunk_counts": result["chunk_counts"],
        "mismatches": result["mismatches"],
        "kernels": kernels,
        "ok": result["ok"],
    }
