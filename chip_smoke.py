#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repo root on a machine with a card:

    python3 chip_smoke.py

It drives ``k8s_spot_rescheduler_tpu_torch`` (never the JAX package) at
the north-star shape, synthetic config 3 (2,500 on-demand + 2,500 spot
nodes, 50,000 pods, packed to C=2560 K=32 S=2560 R=4), frozen with the
JAX package's answers in ``k8s_spot_rescheduler_tpu_torch/data/``:

1. the card (name, power limit) and the kernel build, timed;
2. kernels B1, B2 and B3 against their plain PyTorch versions on the
   card, on the config-3 pack and on seeded random packs: feasible
   vectors and assignments must be bit-identical; each kernel timed
   (median over 20 launches after warm-up, CUDA events);
3. the planning tick against the frozen answers: the drain schedule
   (horizon 32), the staged selection, a second tick through the
   resident delta cache after committing the schedule's first drain
   (equal to a fresh full upload and to the schedule's second step),
   the unstaged selection, and config 4 likewise; the launch counts of
   the main path (reset just before, read just after) must show every
   kernel of the path ran. B3's path is the same tick with the
   first-fit pass forced through spot chunks of 512;
4. the contended problem (512 anti-affinity quality pools, frozen with
   the JAX package's answers): greedy leaves most valid lanes unproven,
   so repair runs on the card; the union's and repair's feasible
   vectors and assignments, the schedule and both selections must equal
   the JAX package's, and the contended tick is timed.

Any mismatch or error exits non-zero. Without a card, or without the
rest of the repo beside it, it exits non-zero and prints no result. The
last lines are the ``nvidia-smi`` name/power-limit line, one JSON
object of kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM
SPOT_CHUNK = 512  # B3's forced chunk


class SmokeFailure(RuntimeError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0].strip()


def time_ms(torch, fn, reps: int = 20, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def random_packed(np, rng, C, K, S, R, W=1, A=2):
    """A seeded random host pack exercising every predicate (integral
    capacities drawn from a small range, so best-fit ties are common)."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster

    def bits(shape, p):
        return (
            (np.uint32(1) << rng.integers(0, 32, shape).astype(np.uint32))
            * (rng.random(shape) < p)
        ).astype(np.uint32)

    return PackedCluster(
        slot_req=rng.integers(0, 60, (C, K, R)).astype(np.float32) * 10,
        slot_valid=rng.random((C, K)) < 0.8,
        slot_tol=rng.integers(0, 4, (C, K, W)).astype(np.uint32),
        slot_aff=bits((C, K, A), 0.3),
        cand_valid=rng.random((C,)) < 0.9,
        spot_free=rng.integers(-10, 150, (S, R)).astype(np.float32) * 10,
        spot_count=rng.integers(0, 5, (S,)).astype(np.int32),
        spot_max_pods=rng.integers(1, 12, (S,)).astype(np.int32),
        spot_taints=rng.integers(0, 4, (S, W)).astype(np.uint32),
        spot_ok=rng.random((S,)) < 0.9,
        spot_aff=bits((S, A), 0.3),
    )


def same(torch, a, b) -> float:
    """max |a - b| over feasible and assignment (0 = bit-identical);
    raises unless both are exactly equal."""
    check(a.feasible.dtype == b.feasible.dtype, "feasible dtypes differ")
    check(a.assignment.shape == b.assignment.shape, "assignment shapes differ")
    err = max(
        (a.feasible.int() - b.feasible.int()).abs().max().item()
        if a.feasible.numel() else 0,
        (a.assignment.long() - b.assignment.long()).abs().max().item()
        if a.assignment.numel() else 0,
    )
    return float(err)


def ffd_bound(np, packed, raw_chosen, best_fit: bool):
    """(bound_ms, bound_by) of one greedy pass on ``packed``: the bytes
    the function must move over the card's memory rate, and the
    predicate operations this data needs over the f32 rate. Both count
    what this data needs. Bytes: the request, toleration and affinity
    rows of live slots (valid slots of valid lanes; the kernel skips
    the rest), the validity bits of valid lanes, ``cand_valid`` and
    every spot array once, feasible + assignment written once.
    Operations: each tested (pod, spot) pair costs R + W + A + 3 (+2 for
    best-fit's slack compare); first-fit needs the spots up to the
    first fit (all S when none fits), best-fit all S."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    W = packed.spot_taints.shape[1]
    A = packed.spot_aff.shape[1]
    cand = np.asarray(packed.cand_valid)
    live = np.asarray(packed.slot_valid) & cand[:, None]
    spot_bytes = sum(
        np.asarray(getattr(packed, f)).nbytes
        for f in packed._fields if f.startswith("spot_")
    )
    nbytes = (
        int(live.sum()) * 4 * (R + W + A)  # f32 requests, int32 words
        + int(cand.sum()) * K + C + spot_bytes  # validity bits, spots
        + C + C * K * 4  # feasible, assignment
    )
    if best_fit:
        tested = int(live.sum()) * S
        per = R + W + A + 5
    else:
        chosen = np.asarray(raw_chosen)
        tested = int(np.where(chosen >= 0, chosen + 1, S)[live].sum())
        per = R + W + A + 3
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = tested * per / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def union_breakdown(torch, fk, packed) -> str:
    """Median ms of each pass of one union solve on ``packed`` (CUDA
    events, 5 runs): where the tick's device time goes."""
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import with_repair
    from k8s_spot_rescheduler_tpu_torch.solver.prefilter import (
        lane_maybe_feasible,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair
    from k8s_spot_rescheduler_tpu_torch.solver.validate import (
        validate_assignment,
    )

    assign = fk.plan_ffd_kernel(packed).assignment
    parts = [
        ("prefilter", lambda: lane_maybe_feasible(packed)),
        ("B1 first-fit", lambda: fk.plan_ffd_kernel(packed)),
        ("B2 best-fit", lambda: fk.plan_ffd_kernel(packed, best_fit=True)),
        ("repair (plain: partial pass, 8 rounds, validate)",
         lambda: plan_repair(packed)),
        ("validate (plain)", lambda: validate_assignment(packed, assign)),
        ("union", lambda: with_repair(fk.greedy_solver(), 8)(packed)),
    ]
    return "; ".join(
        f"{name} {time_ms(torch, fn, reps=5, warmup=1):.3f} ms"
        for name, fn in parts
    )


def contended_phase(np, torch, fk, host, ans, kind, card) -> str:
    """Phase 4: the contended problem on the card, where repair runs.
    Raises on any mismatch with the JAX package's frozen answers;
    returns the line of its times."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        PlannerConfig,
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        with_best_fit_fallback,
        with_repair,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair

    dev = to_device(host, "cuda")
    C, K = host.slot_valid.shape
    for bf in (False, True):
        check(same(torch, fk.plan_ffd_kernel(dev, best_fit=bf),
                   plan_ffd(dev, best_fit=bf)) == 0,
              f"contended: kernel best_fit={bf} != plain")
    check(same(torch, fk.plan_ffd_chunked(dev, 256), plan_ffd(dev)) == 0,
          "contended: B3 != plain first-fit")

    def lanes_equal(res, prefix):
        return (np.array_equal(res.feasible.cpu().numpy(), ans[f"{prefix}_feasible"])
                and np.array_equal(res.assignment.cpu().numpy(),
                                   ans[f"{prefix}_assignment"]))

    greedy = with_best_fit_fallback(fk.greedy_solver())(dev)
    union = with_repair(fk.greedy_solver(), 8)(dev)
    n_greedy = int(greedy.feasible.sum())
    n_union = int(union.feasible.sum())
    check(n_greedy < n_union, "contended: repair proved no lane on the card")
    check(lanes_equal(union, "union"), "contended: union != the JAX package's")
    check(lanes_equal(plan_repair(dev, rounds=8), "repair"),
          "contended: plan_repair != the JAX package's")

    planner = TorchSolverPlanner(device="cuda")
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    steps, mat = planner.plan_schedule_packed(host)
    sched_s = time.perf_counter() - t0
    sel = planner.plan_packed(host)
    launches = dict(fk.LAUNCHES)
    check(launches["B1"] > 0 and launches["B2"] > 0,
          f"contended: greedy kernels not launched {launches}")
    check(np.array_equal(mat, ans["schedule"]),
          "contended: schedule matrix != the JAX package's")
    got = np.concatenate([[sel.index, int(sel.found), sel.n_feasible], sel.row])
    check(np.array_equal(got, ans["staged_selection"]),
          "contended: staged selection != the JAX package's")
    fused = TorchSolverPlanner(PlannerConfig(staged_chunk_lanes=0), device="cuda")
    sel_f = fused.plan_packed(host)
    got = np.concatenate([[sel_f.index, int(sel_f.found), sel_f.n_feasible],
                          sel_f.row])
    check(np.array_equal(got, ans["selection"]),
          "contended: unstaged selection != the JAX package's")
    log(f"[4] contended C={C} K={K} S={host.spot_free.shape[0]} "
        f"W={host.spot_taints.shape[1]}: greedy proves {n_greedy}, the union "
        f"{n_union} of {int(host.cand_valid.sum())} valid lanes on the card; "
        f"union, plan_repair, schedule ({len(steps)} steps), staged and "
        f"unstaged selections == JAX; launches {launches}")

    tick_ms, sched_ms = [], []
    for _ in range(5):
        t0 = time.perf_counter()
        planner.plan_packed(host)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        planner.plan_schedule_packed(host)
        sched_ms.append((time.perf_counter() - t0) * 1e3)
    return (
        f"[4] contended union passes, all {C} lanes: "
        f"{union_breakdown(torch, fk, dev)}; steady staged tick (repair "
        f"runs) median {statistics.median(tick_ms):.3f} ms over 5, 32-step "
        f"schedule median {statistics.median(sched_ms):.3f} ms over 3 (first "
        f"{sched_s * 1e3:.3f} ms); host clock around synced fetches, on "
        f"{kind} [{card}]"
    )


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if here not in sys.path:
        sys.path.insert(0, here)
    try:
        from k8s_spot_rescheduler_tpu_torch.models.tensors import (
            load_npz,
            to_device,
        )
    except ImportError as err:
        print(f"chip_smoke: the port package is missing: {err}", file=sys.stderr)
        return 2
    from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels as fk
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        PlannerConfig,
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu_torch.solver.schedule import commit_step_host

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()

    # ---- phase 1: card and build --------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} | nvidia-smi: {card} | "
        f"device_count={torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_path = fk.build()
    lib = fk.library()
    build_s = time.perf_counter() - t0
    smem = lib.ffd_max_dynamic_smem(0)
    log(f"[1] kernel build {build_s:.2f} s -> {os.path.relpath(lib_path, here)}; "
        f"max dynamic smem {smem} B")
    for line in fk.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1] ptxas: {line.strip()}")

    data = os.path.join(here, "k8s_spot_rescheduler_tpu_torch", "data")
    host3, ans3 = load_npz(os.path.join(data, "config3_seed0.npz"))
    host4, ans4 = load_npz(os.path.join(data, "config4_seed0.npz"))
    hostc, ansc = load_npz(os.path.join(data, "contended_seed0.npz"))
    dev3 = to_device(host3, "cuda")
    C, K, R = host3.slot_req.shape
    S = host3.spot_free.shape[0]
    log(f"[2] config 3 pack: C={C} K={K} S={S} R={R} "
        f"W={host3.spot_taints.shape[1]} A={host3.spot_aff.shape[1]} "
        f"lane state {lib.ffd_state_bytes(R, host3.spot_aff.shape[1], S)} B")

    # ---- phase 2: kernels against their plain versions ----------------
    rng = np.random.default_rng(0)
    for i in range(24):
        shape = (
            (int(rng.integers(1, 40)), int(rng.integers(1, 9)),
             int(rng.integers(1, 700)), int(rng.integers(1, 5)))
            if i < 20 else (300, 32, 9000 if i == 23 else 2560 + 37 * i, 4)
        )
        host = random_packed(np, rng, *shape)
        dev = to_device(host, "cuda")
        for bf in (False, True):
            check(same(torch, fk.plan_ffd_kernel(dev, best_fit=bf),
                       plan_ffd(dev, best_fit=bf)) == 0,
                  f"random pack {i} {shape}: kernel best_fit={bf} != plain")
        if shape[2] == 9000:
            check(not fk.state_fits_smem(shape[3], 2, shape[2], 0),
                  "the S=9000 pack should hold its lane state in device memory")
        chunk = max(1, shape[2] // 3)
        check(same(torch, fk.plan_ffd_chunked(dev, chunk),
                   fk.plan_ffd_chunked_plain(dev, chunk)) == 0,
              f"random pack {i}: B3 != its plain chunk loop")
        check(same(torch, fk.plan_ffd_chunked(dev, chunk), plan_ffd(dev)) == 0,
              f"random pack {i}: B3 != plain first-fit")
    torch.cuda.synchronize()
    log("[2] 24 seeded random packs (the last, S=9000, with the lane state "
        "in device memory): B1, B2, B3 bit-identical to the plain versions")

    plain_ff = plan_ffd(dev3)
    plain_bf = plan_ffd(dev3, best_fit=True)
    b1 = fk.plan_ffd_kernel(dev3)
    b2 = fk.plan_ffd_kernel(dev3, best_fit=True)
    b3 = fk.plan_ffd_chunked(dev3, SPOT_CHUNK)
    b3_plain = fk.plan_ffd_chunked_plain(dev3, SPOT_CHUNK)
    err1 = same(torch, b1, plain_ff)
    err2 = same(torch, b2, plain_bf)
    err3 = max(same(torch, b3, b3_plain), same(torch, b3, b1))
    check(err1 == 0, "config 3: B1 != plain first-fit")
    check(err2 == 0, "config 3: B2 != plain best-fit")
    check(err3 == 0, "config 3: B3 != plain chunk loop / unchunked B1")
    _, raw_ff = fk.launch_raw(dev3, False)
    raw_ff = raw_ff.cpu().numpy()
    log(f"[2] config 3: B1, B2, B3 (Sc={SPOT_CHUNK}) bit-identical to plain; "
        f"feasible lanes ff={int(b1.feasible.sum())} bf={int(b2.feasible.sum())}")

    specs = [
        ("B1", "first-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:85",
         lambda: fk.plan_ffd_kernel(dev3), lambda: plan_ffd(dev3), err1,
         ffd_bound(np, host3, raw_ff, False)),
        ("B2", "best-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:156",
         lambda: fk.plan_ffd_kernel(dev3, best_fit=True),
         lambda: plan_ffd(dev3, best_fit=True), err2,
         ffd_bound(np, host3, None, True)),
        ("B3", f"first-fit over spot chunks of {SPOT_CHUNK}",
         "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:351",
         lambda: fk.plan_ffd_chunked(dev3, SPOT_CHUNK),
         lambda: fk.plan_ffd_chunked_plain(dev3, SPOT_CHUNK), err3,
         ffd_bound(np, host3, raw_ff, False)),
    ]
    timings = {}
    for name, what, replaces, kern, plain, err, (bound_ms, bound_by) in specs:
        ms = time_ms(torch, kern)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        timings[name] = dict(
            name=name, what=what, route="cuda",
            source="k8s_spot_rescheduler_tpu_torch/ops/csrc/ffd.cu",
            replaces=replaces, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        )
        log(f"[2] {name} ({what}): {ms:.4f} ms kernel, {plain_ms:.4f} ms "
            f"plain, bound {bound_ms:.6f} ms ({bound_by}) on {kind} [{card}]")

    # ---- phase 3: the tick against the JAX package's frozen answers ---
    planner = TorchSolverPlanner(device="cuda")
    fk.reset_launch_counts()
    t0 = time.perf_counter()
    steps, mat = planner.plan_schedule_packed(host3)
    sched_s = time.perf_counter() - t0
    sel = planner.plan_packed(host3)
    stats = planner.last_stats
    tick2 = commit_step_host(host3, steps[0].index, steps[0].row)
    sel2 = planner.plan_packed(tick2)
    main_launches = dict(fk.LAUNCHES)
    upload2 = planner.last_upload
    log(f"[3] main path launches: {main_launches}")
    for name in ("B1", "B2"):
        check(main_launches[name] > 0, f"{name} never launched on the main path")

    check(np.array_equal(mat, ans3["schedule"]),
          "config 3: schedule matrix != the JAX package's")
    staged = ans3["staged_selection"]
    got = np.concatenate([[sel.index, int(sel.found), sel.n_feasible], sel.row])
    check(np.array_equal(got, staged),
          f"config 3: staged selection {got[:3]} != JAX {staged[:3]}")
    check(upload2[0] >= 0 and not upload2[1],
          f"second tick did not go through the delta cache: {upload2}")
    fresh2 = TorchSolverPlanner(device="cuda").plan_packed(tick2)
    check(sel2.index == fresh2.index and sel2.found == fresh2.found
          and sel2.n_feasible == fresh2.n_feasible
          and np.array_equal(sel2.row, fresh2.row),
          "delta-cache tick != fresh full upload")
    check(sel2.found and sel2.index == int(mat[1, 0])
          and np.array_equal(sel2.row, mat[1, 3:]),
          "delta-cache tick != the schedule's second step")
    log(f"[3] config 3: schedule ({len(steps)} steps, {sched_s:.3f} s) == JAX; "
        f"staged selection idx={sel.index} n_feasible={sel.n_feasible} == JAX "
        f"({stats}); "
        f"delta tick ({upload2[0]} lanes, {upload2[2]} B) == full upload == "
        f"schedule step 2; fetches_total={planner.fetches_total}")

    fused = TorchSolverPlanner(PlannerConfig(staged_chunk_lanes=0), device="cuda")
    sel_f = fused.plan_packed(host3)
    got = np.concatenate([[sel_f.index, int(sel_f.found), sel_f.n_feasible], sel_f.row])
    check(np.array_equal(got, ans3["selection"]),
          "config 3: unstaged selection != the JAX package's")
    p4 = TorchSolverPlanner(device="cuda")
    _, mat4 = p4.plan_schedule_packed(host4)
    sel4 = p4.plan_packed(host4)
    got = np.concatenate([[sel4.index, int(sel4.found), sel4.n_feasible], sel4.row])
    check(np.array_equal(mat4, ans4["schedule"]), "config 4: schedule != JAX")
    check(np.array_equal(got, ans4["staged_selection"]),
          "config 4: staged selection != JAX")
    log("[3] config 3 unstaged selection == JAX; config 4 schedule and "
        "staged selection == JAX")

    chunked = TorchSolverPlanner(device="cuda", spot_chunk=SPOT_CHUNK)
    fk.reset_launch_counts()
    sel_c = chunked.plan_packed(host3)
    chunk_launches = dict(fk.LAUNCHES)
    check(chunk_launches["B3"] > 0, "B3 never launched on its path")
    check(sel_c.index == sel.index and np.array_equal(sel_c.row, sel.row)
          and sel_c.n_feasible == sel.n_feasible,
          "chunked first-fit tick != the main tick")
    log(f"[3] B3 path (first-fit over spot chunks of {SPOT_CHUNK}) launches: "
        f"{chunk_launches}; selection == main tick")

    lo = sel.index // 256 * 256  # the staged tick's solved chunk
    chunk3 = dev3._replace(
        slot_req=dev3.slot_req[lo:lo + 256],
        slot_valid=dev3.slot_valid[lo:lo + 256],
        slot_tol=dev3.slot_tol[lo:lo + 256],
        slot_aff=dev3.slot_aff[lo:lo + 256],
        cand_valid=dev3.cand_valid[lo:lo + 256],
    )
    log(f"[3] union passes, all {C} lanes: {union_breakdown(torch, fk, dev3)} "
        f"on {kind} [{card}]")
    log(f"[3] union passes, the 256-lane chunk at {lo}: "
        f"{union_breakdown(torch, fk, chunk3)} on {kind} [{card}]")

    tick_ms, sched_ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        planner.plan_packed(host3)  # zero-row delta: the steady tick
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        planner.plan_schedule_packed(host3)
        sched_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[3] steady tick (staged plan, empty delta) median "
        f"{statistics.median(tick_ms):.3f} ms over 10; 32-step schedule median "
        f"{statistics.median(sched_ms):.3f} ms over 3 (first one "
        f"{sched_s * 1e3:.3f} ms); fetches_total={planner.fetches_total}; "
        f"host clock around synced fetches, on {kind} [{card}]")

    out = []
    for name, launches, path in (
        ("B1", main_launches["B1"], "main"),
        ("B2", main_launches["B2"], "main"),
        ("B3", chunk_launches["B3"], f"tick with spot chunks of {SPOT_CHUNK}"),
    ):
        row = dict(timings[name])
        row.pop("what")
        row["launches"] = launches
        row["path"] = path
        out.append(row)
    log(contended_phase(np, torch, fk, hostc, ansc, kind, card))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
