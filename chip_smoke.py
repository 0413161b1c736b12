#!/usr/bin/env python3
"""Chip smoke of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repo root on a machine with a card:

    python3 chip_smoke.py

It drives ``k8s_spot_rescheduler_tpu_torch`` (never the JAX package) at
the north-star shape, synthetic config 3 (2,500 on-demand + 2,500 spot
nodes, 50,000 pods, packed to C=2560 K=32 S=2560 R=4), frozen with the
JAX package's answers in ``k8s_spot_rescheduler_tpu_torch/data/``:

1. the card (name, power limit) and the kernel build, timed (one
   ``nvcc`` per source, all started together);
2. kernels B1, B2 and B3 against their plain PyTorch versions on the
   card, on the config-3 pack, on seeded random packs (one, S=9000,
   with the spot statics read from device memory) and on the packs that
   stress the touched-spot overlay (``testing``): feasible
   vectors and assignments must be bit-identical, B1/B2's raw outputs
   too; B3 launched once per call, at chunk widths 1, 2, 3, 64, 256,
   640 and 866 and at S=24000 past shared memory; the launch geometry (``ops/ffd_kernels.launch_geometry``:
   lanes per block, warps per lane, where the statics live, shared
   memory, blocks) printed, and every geometry of a sweep bit-identical
   to the default one; each kernel timed on all lanes and on the staged
   tick's 256-lane chunk: one wrapper call (``ms``: median of 20 after
   warm-up, CUDA events around the call, host work included) and its
   device time (``device_ms``: the mean over 20 calls of the time
   torch.profiler records in the kernel, null when it records none); B3
   at the spot chunks of the streamed union's four-chunk first-fit; and
   B1-B4 past one lane's shared memory (``testing.past_smem_pack``,
   K=2,200 at W=17), their lanes in the device-memory workspace,
   bit-identical to their plain versions;
3. the planning tick against the frozen answers: the drain schedule
   (horizon 32), the staged selection, a second tick through the
   resident delta cache after committing the schedule's first drain
   (equal to a fresh full upload and to the schedule's second step),
   the unstaged selection, and config 4 likewise; the launch counts of
   the main path (reset just before, read just after) must show B1 and
   B2 ran;
4. the contended problem (512 anti-affinity quality pools, frozen with
   the JAX package's answers): greedy leaves most valid lanes unproven,
   so repair runs on the card; the union's and repair's feasible
   vectors and assignments, the schedule and both selections must equal
   the JAX package's, and the contended tick is timed. Then B5 (repair's
   partial pass and rounds in one launch, ``repair_phase``) lane for
   lane against plain ``plan_repair`` on the harvested tick, the
   contended problem, seeded packs where direct and chain moves fire,
   and a pack whose lanes all pass greedy, one launch a call, and timed
   on the harvested tick;
5. the carry-streamed narrow union (``union_program(8, carry_chunks=n,
   carry_layout=carry_layout(pack))`` with the kernels on: first-fit
   B3 in one launch over n spot chunks, best-fit B4 with the narrow
   delta carry in its overlay, spot-chunked repair): B4 against its
   plain version and B2 on seeded random packs covering every carry
   dtype, on the stress packs with their own layouts, and at S=24000
   with the statics in device memory and the overlay in shared memory,
   bit-identical; then for n in (2, 4) on configs 3, 4 and contended,
   the fused and staged selections and the 32-step schedule equal the
   frozen JAX answers, and on contended the union's and
   ``plan_repair_chunked``'s lanes equal the JAX package's streamed
   answers; the launch counts of this path must show B3 and B4 ran, B3
   once per first-fit call. B4 is timed at config 3 beside B2, its
   plain version and bound, with the union's passes and the streamed
   tick and schedule;
6. the controller at full width: the port's ``Rescheduler`` with
   ``TorchSolverPlanner`` on the card drives each run of
   ``testing.CONTROLLER_RUNS`` (config 3, 5 ticks with schedules on and
   3 with ``schedule_horizon=0``; config 4, 3 ticks; each through the
   object path and through the columnar mirror, the default) from a
   fresh ``generate_cluster(..., reschedule_evicted=True)`` whose digest
   must equal the frozen one, and every tick must drain the node, evict
   the pod UIDs and skip for the reason the JAX package's run on the
   same path did (``data/ticks_seed0.json``), with B1 and B2 launched,
   no tick on the fallback planner and the fallback counter at 0; every
   pack must come from the run's observe path (the planner's
   observations and the ``plan.pack`` spans' ``source`` attribute), so
   a silent fall back from the mirror to objects fails. Each tick's
   latency and its phase split (from the tick's span tree) are printed.
   After each run's first plan, B1 and B2 are held bit-identical to
   their plain versions (results and raw outputs) on the controller's
   own resident pack and on its first staged chunk; the first mirror
   run's pack gives B1's and B2's numbers in the ``kernels`` line. Then
   ``python -m k8s_spot_rescheduler_tpu_torch`` (``testing.CLI_ARGS``)
   runs as a subprocess and must exit 0 draining what the frozen CLI
   run drained, with ``planner_fallback_total=0``;
7. the production observe path: ``testing.StubApiServer`` serves config
   3 at seed 0 over HTTP on 127.0.0.1; the CLI's ``start_watch_client``
   seeds a ``WatchingKubeClusterClient`` by LIST (timed), its
   ``ColumnarFeed`` seeds the mirror (timed), and the port's controller
   runs ``testing.KUBE_RUNS`` (3 ticks, schedules off), each tick after
   the mirror caught up with the stub's events, held against the JAX
   package's frozen run through the same stub, on the mirror, with no
   fallback planner; each tick's split includes the ``kube.get`` reads.
   Then ``python -m k8s_spot_rescheduler_tpu_torch --cluster
   kube:<URL>`` (``testing.KUBE_CLI_ARGS``: watch cache, 2 ticks)
   against a config-1 stub must exit 0 with the frozen drains and
   evicted pods and ``planner_fallback_total=0``. B1/B2's ``launches``
   in the ``kernels`` line are the mirror's path: phase 6's mirror runs
   and phase 7's runs, with phases 10-12's bench runs added (B3/B4's
   are phase 5's with phases 11 and 12's);
8. the multi-tenant planner service: the port's ``ServiceServer`` on
   the card (its kernels built before it listens; ``/healthz`` must name
   B1t/B2t) serves 8 agents (``testing.SERVICE_TENANTS``: configs 3 and
   4 at seeds 0-3, each its own fake cluster at full size, every pack in
   one bucket C=4096 K=64 S=4096), whose cluster digests and first packs'
   fingerprints must equal the frozen ones (``data/service_seed0.json``,
   the JAX package's service on the CPU). Released together, one
   connection each: every selection and every 32-step schedule must
   equal the JAX service's; then ``SERVICE_TICKS`` controller ticks of
   every agent together (the second ships a delta, scattered on the
   card) must drain the frozen nodes and evict the frozen pod UIDs, with
   no agent on its local fallback, the device never marked sick, a batch
   of at least 4 tenants, and every single-plan batch exactly one B1t
   and one B2t launch. Each batch's split (queue wait, assemble, delta
   scatter, upload, solve, fetch, reply) and the per-tenant latency are
   printed beside the same 8 plans made solo by one
   ``TorchSolverPlanner``; B1t/B2t are held bit-identical to their plain
   version and to solo B1/B2 launches on the batch's stack, on it with
   an all-invalid pad tenant and on ``past_smem_pack`` stacked T=3, and
   timed on the batch's stack (their launches in the ``kernels`` line
   are the service's path). Last ``python -m
   k8s_spot_rescheduler_tpu_torch --serve`` runs with an agent CLI
   (``--planner-url``) on config 1, which must drain as the frozen JAX
   CLI run with ``remote_planner_fallback_total=0``, the service
   exiting 0 on SIGTERM;
9. the controller under the kube fault layer (``io/chaos``), the
   mid-drain crash and the chaos CLI, against the JAX package's runs
   with the same faults (``data/chaos_seed0.json``);
10. the bench (``python -m k8s_spot_rescheduler_tpu_torch.bench``, by
   its ``run`` function): ``--config 3`` and ``--config 4`` (selections
   equal the frozen answers; pack, upload, solve+fetch, full tick and
   device-only ms printed), ``--config 3 --trace-dir`` (the device's
   busy share of the timed window from its Chrome trace), the config-5
   replay at 1,000 events and the constrained one at 300,
   ``--quality``, ``--quality-boundary``, ``--chain-depth`` and
   ``--quality-scale``, each holding every count, drain, eviction list,
   ILP value and chain-depth counter equal to the JAX package's
   (``data/bench_seed0.json``), with B1 and B2 launched, the card named
   in the attestation and no fallback; each row's JSON on its own line.
   Then ``--config 3 --repeats 3`` past a forced one-device budget
   (``guard_drive``): the row's program keys, scale note and selection
   equal the root ``bench.py``'s frozen row (``data/bench_seed0.json``
   "guard"), B1 and B2 launch, B3/B4 and the repair passes do not; and
   ``--config 3 --repeats 10000 --watchdog 5`` as a process must exit 3
   printing one line, the watchdog's error row;
11. the root ``bench.py``'s single-device modes in the same bench:
   ``--replay-device-only`` on the frozen harvested constrained-replay
   tick (``data/replay_harvest_seed0.npz``, best-fit and repair fire;
   the device-only ms of the shipped union), ``--carry-wall`` on config
   3 at 4 chunks and at the ladder's count (B3/B4 and repair),
   ``--smoke`` (its row ``ok`` with ``verify_protocol_ms``: the proto
   tier over the port's protocol model, green in its own process),
   ``--pallas-smoke`` (B4 and B1 against the plain streamed
   pass and the oracles), ``--chaos`` and ``--watch-soak`` at 300 ticks,
   every count held against the JAX package's frozen rows, each row's
   JSON on its own line;
12. the root ``bench.py``'s service-side modes in the same bench:
   ``--serve-smoke`` (4 tenants through a ``ServiceServer`` on the card
   over HTTP, co-batched on B1t/B2t, the delta-wire ticks and the
   pooled-reuse phase), ``--sched-smoke``, ``--fleet-chaos`` (two
   replicas on the card through six failure phases), ``--carry-wall
   --config 1`` (a bucket the twins land in), ``--fleet-twin-smoke
   --twin-calibration`` (fed that row and phase 11's carry-wall rows; it
   must charge some batches the measured cost) and ``--storm-smoke``,
   each count and selection held against the JAX package's frozen rows,
   each row's JSON on its own line. The ``launches`` in the ``kernels``
   line add this phase's;
13. the mesh tiers, on a mesh that names the one card
   ``testing.SHARDED_DEVICES`` times (``[cuda:0] * 4``): config 3's
   controller pack (C=2560 K=64 S=2560) through ``TorchSolverPlanner``
   with ``solver_hbm_budget`` set to land on each rung of
   ``testing.SHARDED_RUNGS`` (cand, cand-chunked, cand-carry, 2-D (4,1)
   and (2,2)), the contended pack and the harvested tick through the
   2-D and carry rungs (selections, lanes and dispatch: tier label,
   repair and carry chunks, carry bytes), each against the JAX
   package's answers on 4 virtual CPU devices
   (``data/sharded_seed0.npz``), with the launch counts set to 0 just
   before each run and one B1+B2 (cand rungs) or B3+B4 (carry rungs) a
   lane block; phase 8's fleet through a ``PlannerService`` over a
   tenant mesh of 4 at T=8 and T=6 (padded to 8 with inert tenants; the
   batch log names only the real ones; one B1t and one B2t a block) and
   the tenant batch's carry tier (``carry_chunks=4``), every row equal
   to the JAX service's and to the one-device batch; ``python -m
   k8s_spot_rescheduler_tpu_torch`` with ``testing.SHARDED_CLI_ARGS``
   (``--solver sharded --mesh-shape 1x1`` on config 3), its drains
   equal to the JAX CLI's; the bench's latency rows past the cand and
   cand-carry rungs' forced budgets (config 3) and the 2-D one's under
   ``--solver sharded`` (config 1) over the same mesh, each against the
   root ``bench.py``'s frozen row; and ``bench --scale-smoke``, its
   numbers equal to the root ``bench.py``'s. Each rung's ms a call (CUDA
   events) and launches are printed. One card cannot show concurrency
   between cards nor peer copies; this phase does not claim them.

B5's ``launches`` in the ``kernels`` line are those of B1/B2's paths
where a union's repair gate fired (its time is phase 4's); a mesh
rung's unchunked repair (cand, 2-D) may launch it once a lane block.

Any mismatch or error exits non-zero. Without a card, or without the
rest of the repo beside it, it exits non-zero and prints no result. The
last lines are the ``nvidia-smi`` name/power-limit line, one JSON
object of kernel numbers, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import time

H100_BYTES_PER_S = 3.35e12  # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores, H100 SXM
STREAM_CHUNKS = (2, 4)  # carry chunks of the streamed union's path
B3_WIDTHS = (1, 2, 3, 64, 256, 640, 866)  # B3's chunk widths checked
# substrings of the kernels' names in the profiler: B1-B3, then B4 (this
# tree's, then the older trees' that ffd_timing.py --tree times)
FFD_KERNELS = ("AbsOverlay", "ffd_kernel")
STREAM_KERNELS = ("DeltaOverlay", "stream_bf_kernel")


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


def fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.4f}"


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


def device_ms(torch, fn, kernel, reps: int = 20):
    """Mean device milliseconds per call of ``fn`` spent in the kernels
    whose name contains ``kernel`` (a string, or a tuple of which any
    one) (torch.profiler's CUDA activity over ``reps`` calls after a
    warm-up), or None when the profiler records no device time for
    them."""
    names = (kernel,) if isinstance(kernel, str) else tuple(kernel)
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for ev in prof.key_averages():
        if any(name in ev.key for name in names):
            total += (getattr(ev, "device_time_total", None)
                      or getattr(ev, "cuda_time_total", 0.0))
    return total / reps / 1e3 if total > 0 else None


def layout_packed(np, rng, layout, C, K, S, R):
    """A seeded random host pack whose ``carry_layout`` is exactly
    ``layout``: lane 0's first slot requests 100, 40,000 (past int16) or
    70,000 (past uint16) on a spot that holds it, the other requests
    keep a lane's sum inside int16, and the affinity bits reach bit 7, 15
    or 31; an int16 count needs K >= 128."""
    from k8s_spot_rescheduler_tpu_torch.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu_torch.testing import random_bits, random_pack

    host = random_pack(rng, C, K, S, R)
    top = {"uint8": 8, "uint16": 16, "uint32": 32}[layout.aff]
    aff = random_bits(rng, (C, K, 2), top=top)
    aff[0, 0, 0] = np.uint32(1) << (top - 1)
    req = rng.integers(0, min(60, 3270 // K), (C, K, R)).astype(np.float32) * 10
    req[0, 0, 0] = {"int16": 100.0, "uint16": 40000.0,
                    "float32": 70000.0}[layout.used]
    valid = host.slot_valid.copy()
    valid[0, 0] = True
    free = host.spot_free.copy()
    free[S // 2] = 80000.0
    host = host._replace(slot_req=req, slot_valid=valid, slot_aff=aff,
                         spot_free=free)
    check(carry_layout(host) == layout,
          f"random pack has layout {carry_layout(host)}, not {layout}")
    return host


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
    predicate operations this data needs over the f32 rate
    (``ffd_work``)."""
    return work_bound(*ffd_work(np, packed, raw_chosen, best_fit))


def work_bound(nbytes: int, ops: int):
    """(bound_ms, bound_by) of ``nbytes`` moved and ``ops`` f32
    operations on the card."""
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def ffd_work(np, packed, raw_chosen, best_fit: bool):
    """(bytes, operations) one greedy pass on ``packed`` needs, counting
    what this data needs. Only the spots up to the last usable one
    count (``spot_ok``): past it no pod can fit, and a bucket's pad
    spots (not ok, at the end) are no work the tenant needs. Bytes: the
    request, toleration and affinity rows of live slots (valid slots of
    valid lanes; the kernel skips the rest), the validity bits of valid
    lanes, ``cand_valid`` and those spots' arrays once, feasible +
    assignment written once. Operations: each tested (pod, spot) pair
    costs R + W + A + 3 (+2 for best-fit's slack compare); first-fit
    needs the spots up to the first fit (all of them when none fits),
    best-fit all of them."""
    C, K, R = packed.slot_req.shape
    ok = np.flatnonzero(np.asarray(packed.spot_ok))
    S = int(ok[-1]) + 1 if ok.size else 0
    W = packed.spot_taints.shape[1]
    A = packed.spot_aff.shape[1]
    cand = np.asarray(packed.cand_valid)
    live = np.asarray(packed.slot_valid) & cand[:, None]
    spot_bytes = sum(
        np.asarray(getattr(packed, f))[:S].nbytes
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
    return nbytes, tested * per


def geometry_line(fk, packed, best_fit: bool, **kw) -> str:
    """B1/B2's launch geometry on ``packed`` (B3's with ``spot_chunk=``,
    B4's with ``layout=``), as one phrase."""
    g = fk.card_geometry(packed, best_fit, **kw)
    layout = kw.get("layout")
    return (f"{g.lanes_per_block} lanes x {g.warps_per_lane} warps a block, "
            f"statics ({g.statics_bytes} B) in "
            f"{'shared' if g.statics_in_smem else 'device'} memory, "
            f"{g.lane_bytes} B a lane, {g.smem_bytes} B a block, "
            f"{fk.grid_blocks(packed, g, best_fit, layout)} blocks")


def b3_once(torch, fk, packed, chunk: int):
    """B3 on ``packed`` at ``chunk``, checked to launch once."""
    before = fk.LAUNCHES["B3"]
    res = fk.plan_ffd_chunked(packed, chunk)
    check(fk.LAUNCHES["B3"] == before + 1,
          f"B3 at chunk {chunk} launched {fk.LAUNCHES['B3'] - before} times")
    return res


def chunk_phase(np, torch, fk) -> str:
    """B3 against its plain chunk loop at every width of ``B3_WIDTHS``
    (1-64 on S=300, 256-866 on S=2597, whose 866-spot chunks leave a
    last chunk of 865) and at S=24000 past shared memory (chunks of
    12000 read from device memory, of 6000 staged); each call one
    launch. Returns the line of what was checked."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.testing import random_pack

    rng = np.random.default_rng(11)
    small = to_device(random_pack(rng, 40, 8, 300, 4), "cuda")
    large = to_device(random_pack(rng, 300, 32, 2597, 4), "cuda")
    huge = to_device(random_pack(rng, 64, 32, 24000, 4), "cuda")
    cases = [(small if w <= 64 else large, w) for w in B3_WIDTHS]
    cases += [(huge, 12000), (huge, 6000)]
    placed = []
    for dev, w in cases:
        g = fk.card_geometry(dev, False, spot_chunk=w)
        if dev is huge:
            check(g.statics_in_smem == (w == 6000),
                  f"S=24000 chunk {w}: statics in the wrong memory")
        raw_f, raw_c = fk.launch_raw(dev, False, spot_chunk=w)
        got = b3_once(torch, fk, dev, w)
        want = fk.plan_ffd_chunked_plain(dev, w)
        check(same(torch, got, want) == 0,
              f"B3 at chunk {w} (S={dev.spot_free.shape[0]}) != plain")
        check(torch.equal(raw_f, got.feasible), f"B3 raw at chunk {w}")
        placed.append(int((raw_c >= 0).sum()))
    torch.cuda.synchronize()
    return (f"[2] B3 bit-identical to its plain chunk loop, one launch a "
            f"call, at chunk widths {', '.join(map(str, B3_WIDTHS))} (S=300 "
            f"/ 2597) and 12000 / 6000 at S=24000 (statics in device / "
            f"shared memory); pods placed {placed}")


def geometry_check(torch, fk, packed) -> int:
    """B1 and B2 across lanes per block (L) and warps per lane (P), the
    statics in shared memory, each launch bit-identical to the default
    geometry's; returns the number of geometries checked."""
    C, K, S, R, W, A = fk.shapes(packed)
    n = 0
    for best_fit, pairs in (
        (False, [(L, 1) for L in (1, 4, 8, 16, 20, 32)]),
        (True, [(1, 1), (8, 1), (32, 1), (1, 2), (4, 2), (15, 2), (1, 4),
                (4, 4), (8, 4), (1, 8), (2, 8), (4, 8)]),
    ):
        want = fk.launch_raw(packed, best_fit)
        for L, P in pairs:
            got = fk.launch_raw(packed, best_fit,
                                fk.fixed_geometry(K, S, R, W, A, L, P, True))
            check(all(torch.equal(a, b) for a, b in zip(got, want)),
                  f"geometry L={L} P={P} best_fit={best_fit} changed the answer")
            n += 1
    return n


def overlay_phase(np, torch, fk) -> list:
    """B1/B2 (raw and masked) and B3 against the plain versions on the
    packs that stress the overlay; returns their names."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import ffd_raw, plan_ffd
    from k8s_spot_rescheduler_tpu_torch.testing import overlay_stress_packs

    packs = overlay_stress_packs(0)
    for name, host in packs.items():
        dev = to_device(host, "cuda")
        valid = dev.cand_valid
        for bf in (False, True):
            feasible, chosen = fk.launch_raw(dev, bf)
            want_f, want_c = ffd_raw(dev, bf)
            check(torch.equal(feasible, want_f)
                  and torch.equal(chosen[valid], want_c[valid])
                  and bool((chosen[~valid] == -1).all()),
                  f"overlay pack {name}: raw kernel best_fit={bf} != plain")
            check(same(torch, fk.plan_ffd_kernel(dev, best_fit=bf),
                       plan_ffd(dev, best_fit=bf)) == 0,
                  f"overlay pack {name}: kernel best_fit={bf} != plain")
        chunk = max(1, host.spot_free.shape[0] // 3)
        check(same(torch, b3_once(torch, fk, dev, chunk),
                   fk.plan_ffd_chunked_plain(dev, chunk)) == 0,
              f"overlay pack {name}: B3 != its plain chunk loop")
    torch.cuda.synchronize()
    return list(packs)


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
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        with_best_fit_fallback,
        with_repair,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
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
    fused = TorchSolverPlanner(ReschedulerConfig(staged_chunk_lanes=0),
                               device="cuda")
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


def repair_phase(np, torch, fk, hostc, kind, card):
    """Phase 4's B5 checks: ``ops/ffd_kernels.plan_repair_kernel`` (B5,
    then the plain validation) on the lanes first-fit ∪ best-fit leave
    unproven, one launch a call, lane for lane against plain
    ``plan_repair``, B5's raw rows (``launch_repair_raw``) against the
    plain twin ``plan_repair_plain``, and the union (``with_repair``),
    with the launch counts reset just before, launching B5 once and
    equal to greedy ∪ plain repair, on the harvested tick, the contended
    problem, the seeded ``testing.repair_pack`` packs (direct and chain
    moves fire) and a pack whose valid lanes all pass greedy (every row
    -1; the union's gate skips repair). B5 is timed on the harvested
    tick beside the plain pass and its bound. Returns (lines, the
    kernels-line row)."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.models.tensors import (
        load_npz,
        to_device,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        _prefer,
        with_best_fit_fallback,
        with_repair,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.repair import plan_repair

    greedy_fn = with_best_fit_fallback(fk.greedy_solver())
    saved = dict(fk.LAUNCHES)

    def union_b5(dev):
        """The union on ``dev`` with the launch counts reset just
        before: (result, B5's launches)."""
        fk.reset_launch_counts()
        res = with_repair(fk.greedy_solver(), 8)(dev)
        torch.cuda.synchronize()
        return res, fk.LAUNCHES["B5"]

    def b5_check(name, dev):
        greedy = greedy_fn(dev)
        unproven = dev.cand_valid & ~greedy.feasible
        before = fk.LAUNCHES["B5"]
        got = fk.plan_repair_kernel(dev, unproven, 8)
        check(fk.LAUNCHES["B5"] == before + 1,
              f"[4] B5 on {name}: {fk.LAUNCHES['B5'] - before} launches")
        plain = plan_repair(dev, rounds=8)
        u = unproven
        check(torch.equal(got.feasible[u], plain.feasible[u])
              and torch.equal(got.assignment[u], plain.assignment[u]),
              f"[4] B5 on {name}: an unproven lane != plain plan_repair's")
        check(torch.equal(fk.launch_repair_raw(dev, unproven, 8),
                          fk.plan_repair_plain(dev, unproven, 8)),
              f"[4] B5 on {name}: raw rows != the plain twin's")
        union, b5 = union_b5(dev)
        want = int(bool(u.any()))  # the gate fires where a lane is unproven
        check(b5 == want,
              f"[4] the union on {name}: {b5} B5 launches, want {want}")
        check(same(torch, union, _prefer(greedy, plain)) == 0,
              f"[4] B5 on {name}: the union != greedy ∪ plain repair")
        return int(u.sum()), int((got.feasible & u).sum())

    lines = []
    hosth, _ = load_npz(testing.HARVEST_PATH)
    devh = to_device(hosth, "cuda")
    packs = [("the harvested tick", devh),
             ("contended", to_device(hostc, "cuda"))]
    for shape in testing.REPAIR_SHAPES:
        packs += [(f"repair_pack({seed}, {shape!r})",
                   to_device(testing.repair_pack(seed, shape), "cuda"))
                  for seed in range(4)]
    counts = [(name, *b5_check(name, dev)) for name, dev in packs]
    check(counts[0][1] > 0 and counts[1][1] > 0,
          f"[4] the harvested tick or the contended problem has no "
          f"unproven lane: {counts[:2]}")
    lines.append(
        "[4] B5 (partial pass + 8 rounds, one launch) lane for lane == "
        "plain plan_repair, raw rows == the plain twin, union == greedy ∪ "
        "plain repair, unproven/proved by repair: "
        + ", ".join(f"{n} {u}/{p}" for n, u, p in counts))

    # every valid lane passes greedy: B5 writes -1 rows, the union
    # repairs nothing
    base = to_device(testing.repair_pack(0), "cuda")
    greedy = greedy_fn(base)
    proven = base._replace(cand_valid=(base.cand_valid
                                       & greedy.feasible).contiguous())
    unproven = proven.cand_valid & ~greedy_fn(proven).feasible
    check(not bool(unproven.any()), "[4] the all-proven pack has a gap")
    assign = fk.launch_repair_raw(proven, unproven, 8)
    union, b5 = union_b5(proven)
    check(bool((assign == -1).all()), "[4] B5 wrote a row on a proven lane")
    check(b5 == 0 and same(torch, union, greedy_fn(proven)) == 0,
          "[4] the all-proven pack: the union launched B5 or moved")
    lines.append(f"[4] B5 on a pack whose {int(proven.cand_valid.sum())} "
                 f"valid lanes all pass greedy: every row -1, the union "
                 f"is greedy's with no repair launch")

    # time on the harvested tick (C=512 K=64 S=512)
    unproven = devh.cand_valid & ~greedy_fn(devh).feasible

    def kern():
        return fk.launch_repair_raw(devh, unproven, 8)

    ms = time_ms(torch, kern)
    dev_ms = device_ms(torch, kern, "repair_kernel")
    entry_ms = time_ms(torch, lambda: fk.plan_repair_kernel(devh, unproven,
                                                            8))
    plain_ms = time_ms(torch, lambda: plan_repair(devh, rounds=8), reps=5,
                       warmup=1)
    # the partial pass's work on the unproven lanes: B5 does at least it
    part = hosth._replace(cand_valid=unproven.cpu().numpy())
    bound_ms, bound_by = ffd_bound(np, part, None, True)
    g = fk.card_repair_geometry(devh, 8)
    lines.append(
        f"[4] B5 on the harvested tick ({int(unproven.sum())} unproven "
        f"lanes; {g.lanes_per_block} lanes x {g.warps_per_lane} warps a "
        f"block, {g.lane_bytes} B a lane, {g.smem_bytes} B a block): "
        f"{ms:.4f} ms a launch (CUDA events), {fmt_ms(dev_ms)} ms on "
        f"the device (profiler), {entry_ms:.4f} ms with the plain "
        f"validation (the union's call), {plain_ms:.4f} ms plain "
        f"plan_repair, bound "
        f"{bound_ms:.6f} ms ({bound_by}, the partial pass) on {kind} "
        f"[{card}]")
    row = dict(
        name="B5", what="repair's partial pass and 8 rounds", route="cuda",
        source="k8s_spot_rescheduler_tpu_torch/ops/csrc/repair.cu",
        replaces="none (the JAX package leaves solver/repair.py's "
                 "plan_repair to XLA)",
        max_abs_err=0.0, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    fk.LAUNCHES.update(saved)
    return lines, row


def stream_union_breakdown(torch, fk, packed, layout, n: int) -> str:
    """Median ms of each pass of one streamed union solve (CUDA events,
    5 runs); repair and validate are timed whether or not the union's
    gate runs them."""
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.repair import (
        plan_repair_chunked,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.validate import (
        validate_assignment,
    )

    assign = fk.plan_stream_ff_kernel(
        packed, carry_chunks=n, layout=layout
    ).assignment
    union = union_program(8, carry_chunks=n, carry_layout=layout,
                          use_kernel=True)
    parts = [
        (f"B3 first-fit over {n} spot chunks",
         lambda: fk.plan_stream_ff_kernel(packed, carry_chunks=n,
                                          layout=layout)),
        ("B4 best-fit",
         lambda: fk.plan_stream_bf_kernel(packed, carry_chunks=n,
                                          layout=layout)),
        ("chunked repair (plain: partial pass, 8 rounds, validate)",
         lambda: plan_repair_chunked(packed, rounds=8, spot_chunks=n,
                                     layout=layout)),
        ("validate (plain)", lambda: validate_assignment(packed, assign)),
        ("union as run", lambda: union(packed)),
    ]
    return "; ".join(
        f"{name} {time_ms(torch, fn, reps=5, warmup=1):.3f} ms"
        for name, fn in parts
    )


def stream_phase(np, torch, fk, timings, kind, card, problems) -> dict:
    """Phase 5: the carry-streamed narrow union. Raises on any mismatch;
    adds B4's row to ``timings``; returns the launch counts of the
    streamed union's path (counts reset just before each run of the
    path, read just after, summed)."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver.carry import (
        CarryLayout,
        carry_layout,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import union_program
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd_streamed
    from k8s_spot_rescheduler_tpu_torch.solver.repair import (
        plan_repair_chunked,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.schedule import (
        make_schedule_planner,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.select import (
        StagedPlanner,
        make_fused_planner,
    )
    from k8s_spot_rescheduler_tpu_torch.testing import overlay_stress_packs

    # ---- B4 against its plain version, every carry dtype ---------------
    layouts = [
        CarryLayout(used, count, aff)
        for used in ("int16", "uint16", "float32")
        for count in ("int8", "int16")
        for aff in ("uint8", "uint16", "uint32")
    ]
    narrow3 = CarryLayout("int16", "int8", "uint8")
    rng = np.random.default_rng(5)
    cases = [
        (lay, (int(rng.integers(1, 40)),
               130 if lay.count == "int16" else int(rng.integers(1, 40)),
               int(rng.integers(1, 700)), int(rng.integers(1, 5))))
        for lay in layouts
    ]
    k32 = [lay for lay in layouts if lay.count == "int8"]
    cases += [(k32[4 * i % len(k32)], (300, 32, 2560 + 37 * i, 4))
              for i in range(5)]
    cases.append((narrow3, (64, 32, 24000, 4)))  # past shared memory
    stress = overlay_stress_packs(0)
    packs = [(lay, layout_packed(np, rng, lay, *shape), f"random pack {i} "
              f"{shape}") for i, (lay, shape) in enumerate(cases)]
    packs += [(carry_layout(host), host, f"stress pack {name}")
              for name, host in stress.items()]
    big_line = ""
    for lay, host, what in packs:
        dev = to_device(host, "cuda")
        got = fk.plan_stream_bf_kernel(dev, carry_chunks=2, layout=lay)
        for n in (1, 3):
            check(same(torch, got, plan_ffd_streamed(
                dev, carry_chunks=n, layout=lay, best_fit=True)) == 0,
                f"{what} {lay}: B4 != plain (n={n})")
        check(same(torch, got, fk.plan_ffd_kernel(dev, best_fit=True)) == 0,
              f"{what} {lay}: B4 != B2")
        if host.spot_free.shape[0] == 24000:
            g = fk.card_geometry(dev, True, layout=lay)
            check(not g.statics_in_smem
                  and g.smem_bytes == g.lanes_per_block * g.lane_bytes,
                  "the S=24000 pack should read its statics from device "
                  "memory and hold only its overlay in shared memory")
            big_line = geometry_line(fk, dev, True, layout=lay)
    torch.cuda.synchronize()
    log(f"[5] {len(cases)} seeded random packs (all {len(layouts)} carry "
        f"dtype combinations; the last, S=24000 at config 3's layout: "
        f"{big_line}) and {len(stress)} stress packs ({', '.join(stress)}) "
        f"at their own layouts: B4 bit-identical to the plain streamed "
        f"best-fit and to B2")

    # ---- B4 at config 3: time, plain time, bound ------------------------
    _, host3, _ = problems[0]
    dev3 = to_device(host3, "cuda")
    lay3 = carry_layout(host3)
    C, K, R = host3.slot_req.shape
    S = host3.spot_free.shape[0]
    A = host3.spot_aff.shape[1]
    n4 = STREAM_CHUNKS[-1]
    b4 = fk.plan_stream_bf_kernel(dev3, carry_chunks=n4, layout=lay3)
    err4 = max(
        same(torch, b4, plan_ffd_streamed(dev3, carry_chunks=n4, layout=lay3,
                                          best_fit=True)),
        same(torch, b4, fk.plan_ffd_kernel(dev3, best_fit=True)),
    )
    check(err4 == 0, "config 3: B4 != plain streamed best-fit / B2")

    def b4_call():
        return fk.plan_stream_bf_kernel(dev3, carry_chunks=n4, layout=lay3)

    def b2_call():
        return fk.plan_ffd_kernel(dev3, best_fit=True)

    ms = time_ms(torch, b4_call)
    dev_ms = device_ms(torch, b4_call, STREAM_KERNELS)
    b2_ms = time_ms(torch, b2_call)
    b2_dev = device_ms(torch, b2_call, FFD_KERNELS)
    plain_ms = time_ms(torch, lambda: plan_ffd_streamed(
        dev3, carry_chunks=n4, layout=lay3, best_fit=True), reps=5, warmup=1)
    bound_ms, bound_by = ffd_bound(np, host3, None, True)
    timings["B4"] = dict(
        name="B4", what="fused best-fit stream", route="cuda",
        source="k8s_spot_rescheduler_tpu_torch/ops/csrc/stream_bf.cu",
        replaces="k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:191",
        max_abs_err=err4, ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
    )
    ratio = ("not measured" if dev_ms is None or b2_dev is None
             else f"{dev_ms / b2_dev:.3f}")
    log(f"[5] config 3 layout {tuple(lay3)}: B4 "
        f"{geometry_line(fk, dev3, True, layout=lay3)} (B2 "
        f"{fk.card_geometry(dev3, True).lane_bytes} B a lane); "
        f"B4 {ms:.4f} ms a wrapper call ({fmt_ms(dev_ms)} on the device), "
        f"B2 {b2_ms:.4f} ms in this run ({fmt_ms(b2_dev)} on the device; "
        f"B4/B2 device {ratio}), plain "
        f"streamed best-fit ({n4} chunks) {plain_ms:.4f} ms, bound "
        f"{bound_ms:.6f} ms ({bound_by}) on {kind} [{card}]")

    # ---- the streamed union against the frozen JAX answers --------------
    def lanes_equal(res, ans, prefix):
        return (np.array_equal(res.feasible.cpu().numpy(), ans[f"{prefix}_feasible"])
                and np.array_equal(res.assignment.cpu().numpy(),
                                   ans[f"{prefix}_assignment"]))

    # count the union's first-fit calls: B3 launches once per call
    ff_calls = [0]
    plan_stream_ff_kernel = fk.plan_stream_ff_kernel

    def counted_ff(*args, **kwargs):
        ff_calls[0] += 1
        return plan_stream_ff_kernel(*args, **kwargs)

    totals = {name: 0 for name in fk.LAUNCHES}
    totals["first-fit calls"] = 0
    for name, host, ans in problems:
        dev = to_device(host, "cuda")
        lay = carry_layout(host)
        for n in STREAM_CHUNKS:
            fk.plan_stream_ff_kernel = counted_ff  # bound by the union
            try:
                union = union_program(8, carry_chunks=n, carry_layout=lay,
                                      use_kernel=True)
            finally:
                fk.plan_stream_ff_kernel = plan_stream_ff_kernel
            fk.reset_launch_counts()
            ff_calls[0] = 0
            sel_vec = make_fused_planner(union)(dev).cpu().numpy()
            sel, _ = StagedPlanner(union, chunk_lanes=256,
                                   early_exit=True).solve(dev)
            mat = make_schedule_planner(union, 32)(dev).cpu().numpy()
            lanes = union(dev) if "union_feasible" in ans else None
            launches = dict(fk.LAUNCHES)
            for kernel, count in launches.items():
                totals[kernel] += count
            totals["first-fit calls"] += ff_calls[0]
            check(launches["B3"] > 0 and launches["B4"] > 0,
                  f"{name} n={n}: B3/B4 not launched on the streamed union "
                  f"{launches}")
            check(launches["B3"] == ff_calls[0],
                  f"{name} n={n}: {launches['B3']} B3 launches for "
                  f"{ff_calls[0]} first-fit calls")
            check(np.array_equal(sel_vec, ans["selection"]),
                  f"{name} n={n}: streamed selection != the JAX package's")
            staged = np.concatenate([[sel.index, int(sel.found),
                                      sel.n_feasible], sel.row])
            check(np.array_equal(staged, ans["staged_selection"]),
                  f"{name} n={n}: streamed staged selection != JAX")
            check(np.array_equal(mat, ans["schedule"]),
                  f"{name} n={n}: streamed schedule != the JAX package's")
            extra = ""
            if lanes is not None:
                want = "stream_union" if n == 4 else "union"
                check(lanes_equal(lanes, ans, want),
                      f"{name} n={n}: streamed union lanes != JAX {want}")
                extra = f", union lanes == JAX {want}"
                if n == 4:
                    check(lanes_equal(plan_repair_chunked(
                        dev, rounds=8, spot_chunks=4, layout=lay), ans,
                        "repair_chunked"),
                        f"{name}: plan_repair_chunked != the JAX package's")
                    extra += ", plan_repair_chunked lanes == JAX"
            log(f"[5] {name} layout {tuple(lay)} n={n}: selection, staged "
                f"selection, 32-step schedule == JAX{extra}; launches "
                f"{launches}, one B3 launch for each of {ff_calls[0]} "
                f"first-fit calls")

    union4 = union_program(8, carry_chunks=n4, carry_layout=lay3,
                           use_kernel=True)
    staged4 = StagedPlanner(union4, chunk_lanes=256, early_exit=True)
    tick_ms, sched_ms = [], []
    for _ in range(10):
        t0 = time.perf_counter()
        staged4.solve(dev3)
        tick_ms.append((time.perf_counter() - t0) * 1e3)
    for _ in range(3):
        t0 = time.perf_counter()
        make_schedule_planner(union4, 32)(dev3).cpu()
        sched_ms.append((time.perf_counter() - t0) * 1e3)
    log(f"[5] config 3 streamed union passes (n={n4}), all {C} lanes: "
        f"{stream_union_breakdown(torch, fk, dev3, lay3, n4)} on {kind} "
        f"[{card}]")
    _, hostc, _ = problems[-1]
    devc = to_device(hostc, "cuda")
    log(f"[5] contended streamed union passes (n={n4}), all "
        f"{hostc.slot_req.shape[0]} lanes: "
        f"{stream_union_breakdown(torch, fk, devc, carry_layout(hostc), n4)} "
        f"on {kind} [{card}]")
    log(f"[5] config 3 streamed staged tick (resident tensors, no upload) "
        f"median {statistics.median(tick_ms):.3f} ms over 10; 32-step "
        f"streamed schedule median {statistics.median(sched_ms):.3f} ms over "
        f"3; host clock around synced fetches, on {kind} [{card}]")
    return totals


def past_smem_phase(np, torch, fk) -> list:
    """B1, B2, B3 (2 spot chunks) and B4 (the pack's carry layout) past
    one lane's shared memory (``testing.past_smem_pack``): each launches
    with its lanes in the device-memory workspace and is bit-identical
    to its plain version. Returns the lines of what was checked."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
    from k8s_spot_rescheduler_tpu_torch.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
        plan_ffd,
        plan_ffd_streamed,
    )
    from k8s_spot_rescheduler_tpu_torch.testing import (
        PAST_SMEM_SHAPE,
        past_smem_pack,
    )

    host = past_smem_pack(0)
    dev = to_device(host, "cuda")
    lay = carry_layout(host)
    chunk = -(-host.spot_free.shape[0] // 2)
    limit = fk._smem_limit("ffd", torch.cuda.current_device())
    cases = (
        ("B1", {}, lambda: fk.plan_ffd_kernel(dev), lambda: plan_ffd(dev)),
        ("B2", {}, lambda: fk.plan_ffd_kernel(dev, best_fit=True),
         lambda: plan_ffd(dev, best_fit=True)),
        ("B3", {"spot_chunk": chunk}, lambda: fk.plan_ffd_chunked(dev, chunk),
         lambda: fk.plan_ffd_chunked_plain(dev, chunk)),
        ("B4", {"layout": lay},
         lambda: fk.plan_stream_bf_kernel(dev, carry_chunks=2, layout=lay),
         lambda: plan_ffd_streamed(dev, carry_chunks=2, layout=lay,
                                   best_fit=True)),
    )
    lines = []
    for name, kw, kern, plain in cases:
        best_fit = name in ("B2", "B4")
        g = fk.card_geometry(dev, best_fit, **kw)
        check(not g.lanes_in_smem and g.lane_bytes > limit,
              f"past shared memory: {name} kept its lanes in shared memory")
        before = fk.LAUNCHES[name]
        got = kern()
        check(fk.LAUNCHES[name] == before + 1, f"{name} did not launch once")
        want = plain()
        torch.cuda.synchronize()
        check(same(torch, got, want) == 0,
              f"past shared memory: {name} != its plain version")
        blocks = fk.grid_blocks(dev, g, best_fit, kw.get("layout"))
        lines.append(
            f"[2] past shared memory {name}: {g.lanes_per_block} lanes x "
            f"{g.warps_per_lane} warps a block, {g.lane_bytes} B a lane "
            f"(> {limit} B) in a device-memory workspace of "
            f"{blocks * g.lanes_per_block * g.lane_bytes} B ({blocks} blocks), "
            f"statics ({g.statics_bytes} B) in "
            f"{'shared' if g.statics_in_smem else 'device'} memory, "
            f"{g.smem_bytes} B of shared memory a block; feasible "
            f"{int(got.feasible.sum())} of {int(host.cand_valid.sum())} "
            f"valid lanes; bit-identical to plain"
        )
    C, K, S, R, W, A = PAST_SMEM_SHAPE
    lines.append(f"[2] past-shared-memory pack C={C} K={K} S={S} R={R} W={W} "
                 f"A={A}, carry layout {tuple(lay)}: B1-B4 bit-identical to "
                 f"their plain versions with their lanes in device memory")
    return lines


# span names of a controller tick's trace (utils/tracing.SPAN_NAMES), in
# the order the phase split prints them; kube.get is each read of the
# apiserver (the kube path's actuation reads)
TICK_SPANS = ("observe", "plan.pack", "plan.delta-upload", "plan-dispatch",
              "plan-fetch", "plan.schedule", "observe-metrics", "actuate",
              "kube.get")
# the spans the "rest" of a tick is taken after (they do not nest)
TOP_SPANS = ("observe", "plan-dispatch", "plan-fetch", "plan.schedule",
             "observe-metrics", "actuate")


def span_sums(trace: dict) -> dict:
    """{span name: total ms} over a tick trace's span tree."""
    out = {}
    for sp in walk_spans(trace):
        out[sp["name"]] = out.get(sp["name"], 0.0) + sp["dur_ms"]
    return out


def walk_spans(trace: dict):
    stack = list(trace.get("spans", ()))
    while stack:
        sp = stack.pop()
        yield sp
        stack.extend(sp.get("spans", ()))


def tick_line(tag, name, tick, tick_ms, trace, drained) -> str:
    spans = span_sums(trace)
    named = sum(spans.get(n, 0.0) for n in TOP_SPANS)
    return (f"[{tag}] {name} tick {tick}: {tick_ms:.1f} ms; "
            + ", ".join(f"{n} {spans.get(n, 0.0):.1f}" for n in TICK_SPANS)
            + f", rest (schedule step re-pack + validate, gates, mirror "
            f"wait) {tick_ms - named:.1f} ms; drained {drained}")


def check_observe_path(name, seen, packs, observe) -> None:
    """The planner packed every plan from the observe path the run
    names (``testing.track_observations``), and so say the tick traces'
    ``plan.pack`` spans: a silent fall back to objects fails the run."""
    want = {"columnar": "ColumnarObservation", "kube": "ColumnarObservation",
            "objects": "NodeMap"}[observe]
    span_path = "objects" if observe == "objects" else "columnar"
    check(seen and set(seen) == {want},
          f"{name}: the planner packed from {sorted(set(seen))}, not {want}")
    check(packs and set(packs) == {span_path},
          f"{name}: plan.pack spans from {sorted(set(packs))}, not "
          f"{span_path}")


def controller_pack_check(np, torch, fk, planner, name):
    """B1 and B2 on the controller's own resident pack
    (``planner._device_packed``: the pads, K and affinity layout the
    controller gives them) and on its first staged chunk: results and
    raw outputs bit-identical to the plain versions. The launches made
    here are the comparison's, not the run's: the counts are restored
    before the controller ticks on. Returns a copy of the pack (device,
    host) for ``controller_pack_timings``."""
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import ffd_raw, plan_ffd
    from k8s_spot_rescheduler_tpu_torch.solver.select import _lane_slice

    saved = dict(fk.LAUNCHES)
    dev, host = planner._device_packed, planner._host_prev
    check(dev is not None and host is not None,
          f"{name}: the first tick left no resident pack")
    lanes = planner.config.staged_chunk_lanes or dev.slot_req.shape[0]
    for label, pack in (("pack", dev),
                        (f"{lanes}-lane chunk", _lane_slice(dev, 0, lanes))):
        for bf in (False, True):
            valid = pack.cand_valid
            kern = fk.plan_ffd_kernel(pack, best_fit=bf)
            feasible, chosen = fk.launch_raw(pack, bf)
            want_f, want_c = ffd_raw(pack, bf)
            check(same(torch, kern, plan_ffd(pack, best_fit=bf)) == 0,
                  f"{name}: B{2 if bf else 1} != plain on the controller's "
                  f"{label}")
            check(torch.equal(feasible, want_f)
                  and torch.equal(chosen[valid], want_c[valid])
                  and bool((chosen[~valid] == -1).all()),
                  f"{name}: B{2 if bf else 1} raw outputs != plain on the "
                  f"controller's {label}")
    C, K, R = dev.slot_req.shape
    log(f"[6] {name}: controller pack C={C} K={K} S={dev.spot_free.shape[0]} "
        f"R={R} W={dev.spot_taints.shape[1]} A={dev.spot_aff.shape[1]} and "
        f"its {lanes}-lane chunk: B1 and B2 results and raw outputs "
        f"bit-identical to plain; B1 {geometry_line(fk, dev, False)}; "
        f"B2 {geometry_line(fk, dev, True)}")
    fk.LAUNCHES.update(saved)
    # the resident pack takes the next ticks' deltas in place
    return dev._replace(**{f: t.clone() for f, t in dev._asdict().items()}), host


def controller_pack_timings(np, torch, fk, dev, host, name, lanes, kind,
                            card) -> dict:
    """B1's and B2's numbers for the ``kernels`` line, on the
    controller pack ``dev`` (``host`` its host pack) that
    ``controller_pack_check`` copied, timed after the controller runs
    (the profiler's threads then meet no tick), uncounted."""
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu_torch.solver.select import _lane_slice

    saved = dict(fk.LAUNCHES)
    chunk = _lane_slice(dev, 0, lanes)
    C, K, _ = dev.slot_req.shape
    S = dev.spot_free.shape[0]
    _, raw_ff = fk.launch_raw(dev, False)
    raw_ff = raw_ff.cpu().numpy()
    timings = {}
    for bf, what, replaces in (
        (False, "first-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:85"),
        (True, "best-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:156"),
    ):
        kid = "B2" if bf else "B1"
        bound_ms, bound_by = ffd_bound(np, host, None if bf else raw_ff, bf)
        err = same(torch, fk.plan_ffd_kernel(dev, best_fit=bf),
                   plan_ffd(dev, best_fit=bf))
        check(err == 0, f"{name}: {kid} != plain on the copied pack")

        def kern(bf=bf):
            return fk.plan_ffd_kernel(dev, best_fit=bf)

        def plain(bf=bf):
            return plan_ffd(dev, best_fit=bf)

        ms = time_ms(torch, kern)
        dev_ms = device_ms(torch, kern, FFD_KERNELS)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        chunk_ms = time_ms(torch, lambda bf=bf: fk.plan_ffd_kernel(
            chunk, best_fit=bf))
        timings[kid] = dict(
            name=kid, what=what, route="cuda",
            source="k8s_spot_rescheduler_tpu_torch/ops/csrc/ffd.cu",
            replaces=replaces, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None, pack=f"{name} controller pack C={C} K={K} S={S}",
        )
        log(f"[6] {kid} ({what}) on the {name} controller pack: {ms:.4f} ms "
            f"a wrapper call (CUDA events), {fmt_ms(dev_ms)} ms on the device "
            f"(profiler), {plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms "
            f"({bound_by}); {chunk_ms:.4f} ms a call on the {lanes}-lane "
            f"chunk; on {kind} [{card}]")
    fk.LAUNCHES.update(saved)
    return timings


def check_records(name, records, want) -> None:
    for i, (got, exp) in enumerate(zip(records, want["records"])):
        # the eviction fan-out is concurrent: UIDs compare as sets
        exp = dict(exp, evicted=sorted(exp["evicted"]))
        check(got == exp, f"{name} tick {i + 1}: {got['drained']} "
              f"evicting {len(got['evicted'])} pods (skipped "
              f"{got['skipped']!r}) != the JAX package's {exp['drained']} "
              f"evicting {len(exp['evicted'])} (skipped {exp['skipped']!r})")
    check(len(records) == len(want["records"]), f"{name}: tick count")
    check(not any(rec["planner_fallback"] for rec in records),
          f"{name}: a tick ran on the fallback planner")


def controller_phase(np, torch, fk, kind, card, here):
    """Phase 6: the port's controller at full width on the card against
    the JAX package's frozen runs, through the object path and through
    the columnar mirror, then the CLI as a subprocess. Returns the launch
    counts of the object runs and of the mirror runs (each reset just
    before a run, read just after, summed by path), and B1's and B2's
    timings on the first mirror run's controller pack
    (``controller_pack_check``)."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    frozen = testing.load_ticks()
    totals = {p: {name: 0 for name in fk.LAUNCHES}
              for p in ("objects", "columnar")}
    timed = None  # (name, lanes, device pack, host pack) of the first mirror run
    fallbacks0 = metrics.robustness_snapshot()["planner_fallback"]
    for name, config_id, ticks, horizon, observe in testing.CONTROLLER_RUNS:
        want = frozen["runs"][name]
        spec = CONFIGS[config_id]
        t0 = time.perf_counter()
        client = generate_cluster(spec, frozen["seed"], reschedule_evicted=True)
        gen_s = time.perf_counter() - t0
        digest = testing.cluster_digest(client)
        check(digest == want["digest"],
              f"{name}: generated cluster digest {digest[:16]} != frozen "
              f"{want['digest'][:16]} (a numpy stream difference, not a "
              f"drain)")
        cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                        observe)
        planner = TorchSolverPlanner(cfg, device="cuda")
        seen = testing.track_observations(planner)
        r = Rescheduler(client, planner, cfg, clock=client.clock,
                        recorder=client)
        mirror_s = None
        if observe == "columnar":
            # the mirror attaches at the first tick; its seed is timed here
            t0 = time.perf_counter()
            client.columnar_store(cfg.resources,
                                  on_demand_label=cfg.on_demand_node_label,
                                  spot_label=cfg.spot_node_label)
            mirror_s = time.perf_counter() - t0
        fk.reset_launch_counts()
        records, lines, packs = [], [], []
        checked = False
        for tick in range(ticks):
            t0 = time.perf_counter()
            records += testing.run_ticks(r, client, 1)
            torch.cuda.synchronize()
            tick_ms = (time.perf_counter() - t0) * 1e3
            if not checked and planner._device_packed is not None:
                # the kernels against their plain versions at the shapes
                # this run gives them (uncounted), after its first plan
                dev, host = controller_pack_check(np, torch, fk, planner,
                                                  name)
                if timed is None and observe == "columnar":
                    timed = (name, cfg.staged_chunk_lanes, dev, host)
                checked = True
            trace = (flight.last_tick() or {}).get("trace", {})
            packs += [sp.get("attrs", {}).get("source") for sp in
                      walk_spans(trace) if sp["name"] == "plan.pack"]
            lines.append(tick_line(6, name, tick + 1, tick_ms, trace,
                                   records[-1]["drained"]))
        launches = dict(fk.LAUNCHES)
        for k, v in launches.items():
            totals[observe][k] += v
        for line in lines:
            log(line + f" on {kind} [{card}]")
        check_records(name, records, want)
        check_observe_path(name, seen, packs, observe)
        check(checked, f"{name}: no tick planned on the card")
        check(launches["B1"] > 0 and launches["B2"] > 0,
              f"{name}: B1/B2 not launched by the controller {launches}")
        log(f"[6] {name} (config {config_id}, {ticks} ticks, schedule_horizon="
            f"{horizon}, observe {observe}"
            + (f", mirror seeded in {mirror_s * 1e3:.1f} ms" if mirror_s
               else "")
            + f"): digest == frozen, generated in {gen_s:.1f} s; every "
            f"tick's drain, evicted pod UIDs and skip == the JAX package's "
            f"({sum(len(rec['evicted']) for rec in records)} pods evicted); "
            f"planned from {sorted(set(seen))} ({len(seen)} packs); "
            f"launches {launches}; fetches_total={planner.fetches_total}, "
            f"schedule_lens={planner.schedule_lens}")
    check(metrics.robustness_snapshot()["planner_fallback"] == fallbacks0,
          "the planner-fallback counter moved during the controller runs")

    argv = [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
            *testing.CLI_ARGS]
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=here, env=env, capture_output=True,
                          text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    drained = re.findall(r"tick \d+: drained=(\[.*?\])", proc.stderr)
    want = [repr(rec["drained"]) for rec in frozen["cli"]["records"]]
    check(drained == want, f"CLI drained {drained}, the JAX package {want}")
    fallbacks = re.findall(r"planner_fallback_total=(\d+)", proc.stderr)
    check(fallbacks == ["0"],
          f"CLI planner_fallback_total {fallbacks}: a tick ran on the host")
    log(f"[6] python -m k8s_spot_rescheduler_tpu_torch "
        f"{' '.join(testing.CLI_ARGS)}: exit 0 in {cli_s:.1f} s, drained "
        f"{', '.join(drained)} == the JAX package's CLI run, "
        f"planner_fallback_total=0")
    name, lanes, dev, host = timed
    return totals, controller_pack_timings(np, torch, fk, dev, host, name,
                                           lanes, kind, card)


def native_counters():
    """Count the native decoder's batches and the mirror's bulk seeds:
    wraps ``io/native_ingest.parse_pod_list``/``parse_node_list`` and
    ``ColumnarStore.bulk_add_pods`` (here, not in the package) and
    returns the live counts ({"pods", "nodes", "bulk"}: batches decoded,
    stores seeded in one pass)."""
    from k8s_spot_rescheduler_tpu_torch.io import native_ingest
    from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore

    counts = {"pods": 0, "nodes": 0, "bulk": 0}

    def counted(fn, key):
        def wrapper(*args):
            out = fn(*args)
            if out is not None and out is not False:
                counts[key] += 1
            return out
        return wrapper

    native_ingest.parse_pod_list = counted(native_ingest.parse_pod_list,
                                           "pods")
    native_ingest.parse_node_list = counted(native_ingest.parse_node_list,
                                            "nodes")
    ColumnarStore.bulk_add_pods = counted(ColumnarStore.bulk_add_pods, "bulk")
    return counts


def mirror_pack(watching, cfg):
    """The watch mirror's pack, the seconds its ``ColumnarFeed`` took to
    seed (the first ``columnar_store`` call) and the pack's, and the
    feed's split (``SeedSpans(feed=True)``)."""
    t0 = time.perf_counter()
    with SeedSpans(feed=True) as spans:
        store = watching.columnar_store(
            cfg.resources, on_demand_label=cfg.on_demand_node_label,
            spot_label=cfg.spot_node_label)
    t1 = time.perf_counter()
    packed = store.pack(watching.list_pdbs())[0]
    return packed, t1 - t0, time.perf_counter() - t1, spans.line()


class SeedSpans:
    """Host-clock durations inside a watch seed, by resource: each
    watcher's whole LIST (``Watcher._relist``: GET, decode, store), its
    GET (``_request``: the bytes and ``json.loads``; ``_request_raw``:
    the bytes alone), the native decode into views
    (``native_ingest.parse_pod_list``/``parse_node_list``), the volume
    re-resolution after the sync, and the polling client's LIST +
    decode (``_all_pods``/``_all_nodes``). Wraps those functions (here,
    not in the package) while in use."""

    def __init__(self, feed: bool = False):
        # feed: time the mirror's seed instead (``ColumnarStore.add_node``
        # per node, then ``add_pod`` per pod or one ``bulk_add_pods``)
        self.feed = feed
        self.ms = {}

    def _wrap(self, owner, name, key_of):
        fn = getattr(owner, name)

        def wrapper(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                key = key_of(*args)
                self.ms[key] = (self.ms.get(key, 0.0)
                                + (time.perf_counter() - t0) * 1e3)

        setattr(owner, name, wrapper)
        return owner, name, fn

    def __enter__(self):
        from k8s_spot_rescheduler_tpu_torch.io import kube, native_ingest, watch
        from k8s_spot_rescheduler_tpu_torch.models.columnar import ColumnarStore

        if self.feed:
            self._saved = [
                self._wrap(ColumnarStore, name, lambda *a, n=name: n)
                for name in ("add_node", "add_pod", "bulk_add_pods")]
            return self
        res = {"/api/v1/pods": "pods", "/api/v1/nodes": "nodes"}
        self._saved = [
            self._wrap(watch.Watcher, "_relist",
                       lambda w: f"{w.resource} LIST"),
            self._wrap(kube.KubeClusterClient, "_request",
                       lambda c, m, path, *a: f"{res.get(path, path)} GET "
                                              f"+ json.loads"),
            self._wrap(kube.KubeClusterClient, "_request_raw",
                       lambda c, m, path: f"{res.get(path, path)} GET"),
            self._wrap(native_ingest, "parse_pod_list",
                       lambda data: "pods native decode"),
            self._wrap(native_ingest, "parse_node_list",
                       lambda data: "nodes native decode"),
            self._wrap(watch.WatchingKubeClusterClient, "_refresh_volumes",
                       lambda *a, **kw: "volume re-resolution"),
            self._wrap(kube.KubeClusterClient, "_all_pods",
                       lambda c: "pods polling LIST + decode"),
            self._wrap(kube.KubeClusterClient, "_all_nodes",
                       lambda c: "nodes polling LIST + decode"),
        ]
        return self

    def __exit__(self, *exc):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)

    def line(self) -> str:
        if self.feed:
            return ", ".join(f"{k} {v:.1f}" for k, v in self.ms.items()) + " ms"
        keys = [k for k in self.ms if k.startswith(("pods", "nodes"))]
        return ", ".join(f"{k} {self.ms[k]:.1f}" for k in sorted(keys)) + (
            f", volume re-resolution {self.ms.get('volume re-resolution', 0):.1f}"
            f" ms")


def decode_breakdown(stub, resource: str) -> dict:
    """One LIST of ``resource`` from ``stub`` and its decode both ways,
    alone (no watcher or stub thread competing for the interpreter), in
    seconds: the GET of the raw bytes, the native decode into views, and
    ``json.loads`` + the Python decoder per object."""
    from k8s_spot_rescheduler_tpu_torch.io import kube, native_ingest

    client = kube.KubeClusterClient(stub.url)
    t0 = time.perf_counter()
    body = client._request_raw("GET", f"/api/v1/{resource}")
    t1 = time.perf_counter()
    parse = (native_ingest.parse_pod_list if resource == "pods"
             else native_ingest.parse_node_list)
    views = parse(body).views()
    t2 = time.perf_counter()
    decode = kube.decode_pod if resource == "pods" else kube.decode_node
    objs = [decode(o) for o in json.loads(body)["items"]]
    t3 = time.perf_counter()
    check(len(views) == len(objs), f"{resource}: native and Python counts")
    return {"bytes": len(body), "get": t1 - t0, "native": t2 - t1,
            "python": t3 - t2, "n": len(objs)}


def same_pack(np, a, b) -> bool:
    return all(np.asarray(getattr(a, f)).dtype == np.asarray(getattr(b, f)).dtype
               and np.array_equal(np.asarray(getattr(a, f)),
                                  np.asarray(getattr(b, f)))
               for f in a._fields)


def kube_phase(np, torch, fk, kind, card, here):
    """Phase 7: the production observe path. ``testing.StubApiServer``
    serves config 3 at the frozen seed over HTTP on 127.0.0.1. The CLI's
    ``start_watch_client`` seeds a ``WatchingKubeClusterClient`` twice:
    by LIST through the Python decoders with a per-pod ``ColumnarFeed``
    seed, and by one native LIST decode with the feed's bulk seed
    (``ColumnarStore.bulk_add_pods``), each timed; the two mirrors must
    pack bit-identically and every pod of the native store must be a
    ``PodView``. The port's ``Rescheduler`` ticks on the native mirror
    (``testing.KUBE_RUNS``), each tick after the mirror caught up with
    the server's events, held against the JAX package's frozen run on
    the same stub; then again under a ``ChaosClusterClient`` with only
    watch faults (``testing.WATCH_FAULTS``: scripted 410s, dropped
    streams), whose re-lists must happen and decode natively, with the
    same ticks. Then the polling client (no watch cache) through the
    stub, ``testing.POLL_RUNS``, with the native and the Python
    decoders, against the frozen JAX run, its ``kube.get`` time printed
    both ways. Last the CLI runs as a subprocess with ``--cluster
    kube:URL`` against a config-1 stub. Returns the launch counts of
    the kube runs."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.cli.main import start_watch_client
    from k8s_spot_rescheduler_tpu_torch.io import native_ingest
    from k8s_spot_rescheduler_tpu_torch.io.chaos import (
        ChaosClusterClient,
        FaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.io.kube import KubeClusterClient
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.clock import FakeClock
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    t0 = time.perf_counter()
    check(native_ingest.available(),
          "the native LIST decoder is not available on the card's machine")
    log(f"[7] native LIST decoder built and loaded in "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms -> "
        f"{os.path.relpath(native_ingest.library_path(), here)}")
    counts = native_counters()
    frozen = testing.load_ticks()
    totals = {name: 0 for name in fk.LAUNCHES}
    fallbacks0 = metrics.robustness_snapshot()["planner_fallback"]
    for name, config_id, ticks, horizon in testing.KUBE_RUNS:
        want = frozen["runs"][name]
        spec = CONFIGS[config_id]
        cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                        "kube")
        for faults in (None, testing.WATCH_FAULTS):
            run = name if faults is None else f"{name} under watch faults"
            client = generate_cluster(spec, frozen["seed"])
            check(testing.cluster_digest(client) == want["digest"],
                  f"{run}: generated cluster digest != frozen")
            t0 = time.perf_counter()
            stub = testing.StubApiServer.from_cluster(client)
            encode_s = time.perf_counter() - t0
            n_pods = len(stub.objects["pods"])
            clock = FakeClock()
            timing = {}
            py_pack = None
            if faults is None:
                split = {r: decode_breakdown(stub, r)
                         for r in ("pods", "nodes")}
                log("[7] decoders alone: " + "; ".join(
                    f"{r} LIST ({d['n']} objects, {d['bytes'] / 1e6:.1f} MB): "
                    f"GET {d['get'] * 1e3:.1f} ms, native decode into views "
                    f"{d['native'] * 1e3:.1f} ms, json.loads + Python decoder "
                    f"{d['python'] * 1e3:.1f} ms"
                    for r, d in split.items()) + f" on {kind} [{card}]")
                # the Python seed: LIST + decode_pod, add_pod per pod
                before = dict(counts)
                kc = KubeClusterClient(stub.url)
                kc.use_native_ingest = False
                t0 = time.perf_counter()
                with SeedSpans() as py_spans:
                    py = start_watch_client(kc, cfg, clock)
                timing["py_list"] = time.perf_counter() - t0
                try:
                    (py_pack, timing["py_feed"], timing["py_pack"],
                     timing["py_feed_spans"]) = mirror_pack(py, cfg)
                finally:
                    py.stop()
                check(counts == before, "the Python seed decoded natively")
            planner = TorchSolverPlanner(cfg, device="cuda")
            seen = testing.track_observations(planner)
            lines, packs, chaos = [], [], []
            before = dict(counts)

            def start(kube_client, faults=faults):
                # what the CLI sets: the native decoder where the
                # configured resources fit its schema
                kube_client.use_native_ingest = native_ingest.supports(
                    cfg.resources)
                if faults is not None:
                    chaos.append(ChaosClusterClient(
                        kube_client, FaultPlan(seed=0, **faults),
                        clock=clock))
                    kube_client = chaos[0]
                t0 = time.perf_counter()
                with SeedSpans() as spans:
                    watching = start_watch_client(kube_client, cfg, clock)
                timing["list"] = time.perf_counter() - t0
                timing["spans"] = spans.line()
                return watching

            def seed_mirror(watching, py_pack=py_pack, run=run):
                check(hasattr(watching, "columnar_store"),
                      f"{run}: the watch caches did not sync; the CLI fell "
                      f"back to polling")
                pods = next(w for w in watching._watchers
                            if w.list_path == "/api/v1/pods").store
                kinds = {type(v).__name__ for _, v in pods.snapshot_items()}
                check(kinds == {"PodView"},
                      f"{run}: the seeded store holds {sorted(kinds)}")
                check(counts["pods"] > before["pods"]
                      and counts["nodes"] > before["nodes"],
                      f"{run}: the seed did not decode natively")
                (packed, timing["feed"], timing["pack"],
                 timing["feed_spans"]) = mirror_pack(watching, cfg)
                check(counts["bulk"] == before["bulk"] + 1,
                      f"{run}: the feed did not seed in one bulk pass")
                if py_pack is not None:
                    check(same_pack(np, packed, py_pack),
                          f"{run}: the native mirror's pack != the Python "
                          f"mirror's")

            watchers = []

            def make(watching, lines=lines, packs=packs, run=run):
                watchers.extend(watching._watchers)
                r = Rescheduler(watching, planner, cfg, clock=clock,
                                recorder=watching)
                tick = r.tick

                def timed_tick():
                    t0 = time.perf_counter()
                    res = tick()
                    torch.cuda.synchronize()
                    tick_ms = (time.perf_counter() - t0) * 1e3
                    trace = (flight.last_tick() or {}).get("trace", {})
                    packs.extend(sp.get("attrs", {}).get("source") for sp in
                                 walk_spans(trace)
                                 if sp["name"] == "plan.pack")
                    lines.append(tick_line(7, run, len(lines) + 1, tick_ms,
                                           trace, list(res.drained)))
                    return res

                r.tick = timed_tick
                return r

            fk.reset_launch_counts()
            try:
                records = testing.run_kube(
                    stub, ticks, kube_cls=KubeClusterClient,
                    start_watching=start, clock=clock, make_rescheduler=make,
                    on_ready=seed_mirror)
            finally:
                stub.close()
            launches = dict(fk.LAUNCHES)
            for k, v in launches.items():
                totals[k] += v
            for line in lines:
                log(line + f" on {kind} [{card}]")
            check_records(run, records, want)
            check_observe_path(run, seen, packs, "kube")
            check(launches["B1"] > 0 and launches["B2"] > 0,
                  f"{run}: B1/B2 not launched on the kube path {launches}")
            seeds = {"nodes": 0, "pods": 0}
            for w in watchers:
                for res in seeds:
                    if w.list_path == f"/api/v1/{res}":
                        seeds[res] += w.relist_count
            native = {res: counts[res] - before[res] for res in seeds}
            check(native == seeds,
                  f"{run}: LISTs {seeds} but native decodes {native}")
            extra = ""
            if faults is not None:
                relists = sum(w.relist_count for w in watchers) - len(watchers)
                check(relists >= 1 and chaos[0].stats["watch_410"] >= 1,
                      f"{run}: no re-list under the watch faults "
                      f"({dict(chaos[0].stats)})")
                extra = (f"; faults injected {dict(chaos[0].stats)}, "
                         f"{relists} re-lists, every node and pod LIST "
                         f"decoded natively ({native})")
            else:
                extra = (f"; Python seed: LIST + decode "
                         f"{timing['py_list'] * 1e3:.1f} ms ({py_spans.line()})"
                         f", per-pod feed "
                         f"{timing['py_feed'] * 1e3:.1f} ms "
                         f"({timing['py_feed_spans']}; first pack "
                         f"{timing['py_pack'] * 1e3:.1f} ms); the two "
                         f"mirrors' packs bit-identical; native store all "
                         f"PodView")
            log(f"[7] {run} (config {config_id}, {ticks} ticks, "
                f"schedule_horizon={horizon}): stub encoded {n_pods} pods in "
                f"{encode_s:.1f} s; native seed: start_watch_client LIST + "
                f"decode {timing['list'] * 1e3:.1f} ms ({timing['spans']}), "
                f"ColumnarFeed bulk "
                f"seed {timing['feed'] * 1e3:.1f} ms ({timing['feed_spans']}"
                f"; first pack "
                f"{timing['pack'] * 1e3:.1f} ms){extra}; every tick's "
                f"drain, evicted pod UIDs and skip == the JAX package's "
                f"through the same stub "
                f"({sum(len(rec['evicted']) for rec in records)} pods "
                f"evicted); planned from {sorted(set(seen))}; launches "
                f"{launches}; planner_fallback_total="
                f"{int(metrics.robustness_snapshot()['planner_fallback'])} "
                f"on {kind} [{card}]")

    chaos_frozen = testing.load_chaos()
    for name, config_id, ticks, horizon in testing.POLL_RUNS:
        want = chaos_frozen["poll"][name]
        spec = CONFIGS[config_id]
        cfg = testing.controller_config(ReschedulerConfig, spec, horizon,
                                        "kube")
        for native in (True, False):
            run = f"{name} ({'native' if native else 'Python'} decoders)"
            client = generate_cluster(spec, chaos_frozen["seed"])
            check(testing.cluster_digest(client) == want["digest"],
                  f"{run}: generated cluster digest != frozen")
            stub = testing.StubApiServer.from_cluster(client)
            planner = TorchSolverPlanner(cfg, device="cuda")
            seen = testing.track_observations(planner)
            clock = FakeClock()
            kc = KubeClusterClient(stub.url)
            kc.use_native_ingest = native
            lines, gets = [], []
            before = dict(counts)

            def make(c, lines=lines, gets=gets, run=run):
                r = Rescheduler(c, planner, cfg, clock=clock, recorder=c)
                tick = r.tick

                def timed_tick():
                    t0 = time.perf_counter()
                    res = tick()
                    torch.cuda.synchronize()
                    tick_ms = (time.perf_counter() - t0) * 1e3
                    trace = (flight.last_tick() or {}).get("trace", {})
                    gets.append(span_sums(trace).get("kube.get", 0.0))
                    lines.append(tick_line(7, run, len(lines) + 1, tick_ms,
                                           trace, list(res.drained)))
                    return res

                r.tick = timed_tick
                return r

            fk.reset_launch_counts()
            try:
                with SeedSpans() as spans:
                    records = testing.run_kube_ticks(make(kc), stub, None,
                                                     clock, ticks)
            finally:
                stub.close()
            launches = dict(fk.LAUNCHES)
            for line in lines:
                log(line + f" on {kind} [{card}]")
            check_records(run, records, want)
            check(seen and set(seen) == {"NodeMap"},
                  f"{run}: planned from {sorted(set(seen))}")
            decoded = counts["pods"] - before["pods"]
            check((decoded >= ticks) if native else decoded == 0,
                  f"{run}: {decoded} native pod LISTs in {ticks} ticks")
            check(launches["B1"] > 0 and launches["B2"] > 0,
                  f"{run}: B1/B2 not launched {launches}")
            log(f"[7] {run}: polling client, {ticks} ticks == the JAX "
                f"package's polling run through the same stub; kube.get "
                f"{', '.join(f'{ms:.1f}' for ms in gets)} ms a tick; in "
                f"all {spans.line()}; "
                f"{decoded} native pod LIST decodes; launches {launches} on "
                f"{kind} [{card}]")
    check(metrics.robustness_snapshot()["planner_fallback"] == fallbacks0,
          "the planner-fallback counter moved during the kube runs")

    want = frozen["kube_cli"]
    client = generate_cluster(CONFIGS[testing.KUBE_CLI_CONFIG], frozen["seed"])
    check(testing.cluster_digest(client) == want["digest"],
          "kube CLI: generated cluster digest != frozen")
    stub = testing.StubApiServer.from_cluster(client)
    try:
        argv = [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
                "--cluster", f"kube:{stub.url}", *testing.KUBE_CLI_ARGS]
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=here, env=dict(os.environ,
                              PYTHONPATH=here), capture_output=True,
                              text=True, timeout=600)
        cli_s = time.perf_counter() - t0
    finally:
        stub.close()
    check(proc.returncode == 0,
          f"kube CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    drained = re.findall(r"tick \d+: drained=(\[.*?\])", proc.stderr)
    check(drained == [repr(d) for d in want["drained"]],
          f"kube CLI drained {drained}, the JAX package {want['drained']}")
    check(sorted(stub.evictions) == want["evicted"],
          "kube CLI: evicted pod UIDs != the JAX package's")
    fallbacks = re.findall(r"planner_fallback_total=(\d+)", proc.stderr)
    check(fallbacks == ["0"],
          f"kube CLI planner_fallback_total {fallbacks}")
    log(f"[7] python -m k8s_spot_rescheduler_tpu_torch --cluster "
        f"kube:<stub> {' '.join(testing.KUBE_CLI_ARGS)} (config "
        f"{testing.KUBE_CLI_CONFIG}): exit 0 in {cli_s:.1f} s, drained "
        f"{', '.join(drained)} and evicted {len(stub.evictions)} pods == the "
        f"JAX package's CLI through the same stub, planner_fallback_total=0")
    return totals


def stack_host(np, packs):
    """Host packs of one shape stacked along a leading tenant axis."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import PackedCluster

    return PackedCluster(*(
        np.stack([getattr(p, f) for p in packs]) for f in PackedCluster._fields
    ))


def tenant_check(np, torch, fk, stacked, what: str) -> float:
    """B1t and B2t on the stacked pack (on the card) against their plain
    version and against one solo B1/B2 launch per tenant, results and
    raw outputs; the launches are not counted. Returns max |err|."""
    from k8s_spot_rescheduler_tpu_torch.models.tensors import tenant_slice

    saved = dict(fk.LAUNCHES)
    err = 0.0
    for bf in (False, True):
        got = fk.plan_ffd_tenants_kernel(stacked, best_fit=bf)
        raw_f, raw_c = fk.launch_tenants_raw(stacked, bf)
        plain = fk.plan_ffd_tenants_plain(stacked, bf)
        err = max(err, same(torch, got, plain))
        for t in range(stacked.slot_req.shape[0]):
            tenant = tenant_slice(stacked, t)
            solo = fk.plan_ffd_kernel(tenant, best_fit=bf)
            f, c = fk.launch_raw(tenant, bf)
            torch.cuda.synchronize()
            check(torch.equal(got.feasible[t], solo.feasible)
                  and torch.equal(got.assignment[t], solo.assignment)
                  and torch.equal(raw_f[t], f) and torch.equal(raw_c[t], c),
                  f"{what}: B{'2' if bf else '1'}t tenant {t} != its solo "
                  f"launch")
        check(err == 0, f"{what}: B{'2' if bf else '1'}t != plain")
    fk.LAUNCHES.update(saved)
    return err


def service_phase(np, torch, fk, kind, card, here):
    """Phase 8: the multi-tenant planner service on the card (see the
    module docstring). Returns (launches of the agents' path, the
    kernels-line rows of B1t and B2t, the launches under the service
    fault layer, and the fleet phase 13 lays over a tenant mesh: the
    service's config, the tenant names, their first packs and the frozen
    rows)."""
    import threading
    import urllib.request

    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.models.delta import pack_fingerprint
    from k8s_spot_rescheduler_tpu_torch.models.tensors import (
        PackedCluster,
        tenant_slice,
        to_device,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service import buckets, wire
    from k8s_spot_rescheduler_tpu_torch.service.agent import (
        PooledWireTransport,
        RemotePlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
    from k8s_spot_rescheduler_tpu_torch.testing import past_smem_pack
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    with open(testing.SERVICE_PATH) as f:
        frozen = {t["name"]: t for t in json.load(f)["tenants"]}
    names = [name for name, _, _ in testing.SERVICE_TENANTS]
    n = len(names)
    spec0 = CONFIGS[testing.SERVICE_TENANTS[0][1]]
    # one resync-class ingest slot for each tenant's first full pack, so
    # the fleet's first contact is not shed; a 0.5 s batch window
    server_cfg = testing.service_config(ReschedulerConfig, spec0,
                                        service_resync_ingest_cap=n)
    t0 = time.perf_counter()
    server = ServiceServer(server_cfg, "127.0.0.1:0", batch_window_s=0.5,
                           device="cuda")
    ready_s = time.perf_counter() - t0
    server.start_background()
    url = f"http://{server.address}"
    fallback0 = metrics.service_snapshot()["remote_planner_fallback"]
    pools = []
    try:
        with urllib.request.urlopen(f"{url}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        check("B1t/B2t" in health["batch_program"]
              and health["solve_device"].startswith("cuda"),
              f"/healthz names {health['batch_program']} on "
              f"{health['solve_device']}")

        # ---- the fleet: one fake cluster and one agent a tenant -------
        tenants = []
        t0 = time.perf_counter()
        for name, config_id, seed in testing.SERVICE_TENANTS:
            spec = CONFIGS[config_id]
            cfg = testing.service_config(ReschedulerConfig, spec,
                                         planner_url=url,
                                         planner_timeout=300.0)
            client = generate_cluster(spec, seed, reschedule_evicted=True)
            check(testing.cluster_digest(client) == frozen[name]["digest"],
                  f"{name}: generated cluster digest != frozen")
            agent = RemotePlanner(cfg, tenant=name)
            packed = testing.agent_pack(agent, client)
            check(pack_fingerprint(packed) == frozen[name]["pack_fingerprint"],
                  f"{name}: the agent's pack != the JAX agent's")
            tenants.append((name, cfg, client, agent, packed))
        gen_s = time.perf_counter() - t0
        bucket = buckets.bucket_for(tenants[0][4])
        check(all(buckets.bucket_for(t[4]) == bucket for t in tenants),
              "the fleet's packs fall into more than one bucket")

        def together(fn):
            """fn(i) for every tenant at once (a barrier releases all)."""
            out = [None] * n
            errors = []
            gate = threading.Barrier(n, action=lambda: released.append(
                time.perf_counter()))

            def run(i):
                try:
                    gate.wait(timeout=60)
                    out[i] = fn(i)
                except Exception as err:  # noqa: BLE001 — reported below
                    errors.append(err)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not errors and all(not t.is_alive() for t in threads),
                  f"fleet call failed: {errors}")
            return out

        # one connection a tenant, as each agent keeps its own: a shared
        # keep-alive connection would serialise the requests
        pools = [PooledWireTransport() for _ in range(n)]
        released = []  # host clock of each release of the fleet
        headers = {"Content-Type": "application/octet-stream",
                   "X-Planner-Deadline": "300"}

        def ask(i, horizon=0):
            name, _, _, _, packed = tenants[i]
            t_req = time.perf_counter()
            body = wire.encode_plan_request(name, packed,
                                            schedule_horizon=horizon)
            raw = pools[i](f"{url}/v2/plan", body, headers, 300.0)
            reply = (wire.decode_plan_schedule_reply(raw) if horizon
                     else wire.decode_plan_reply(raw))
            return reply, (time.perf_counter() - t_req) * 1e3

        fk.reset_launch_counts()
        log0 = len(server.service.batch_log)
        # ---- every tenant's selection, released together ---------------
        sel = together(ask)
        for (name, *_), (reply, _) in zip(tenants, sel):
            got = [reply.index, int(reply.found), reply.n_feasible,
                   *np.asarray(reply.row).tolist()]
            check(got == frozen[name]["row"],
                  f"{name}: selection {got[:3]} != the JAX package's "
                  f"{frozen[name]['row'][:3]}")
        # ---- the schedule batch at the frozen horizon ------------------
        horizon = testing.SERVICE_HORIZON
        sched = together(lambda i: ask(i, horizon))
        for (name, *_), (reply, _) in zip(tenants, sched):
            check(np.array_equal(np.asarray(reply.steps),
                                 np.asarray(frozen[name]["schedule"])),
                  f"{name}: {horizon}-step schedule != the JAX package's")
        # ---- the same fleet under the service fault layer --------------
        chaos_launches = service_chaos_phase(np, fk, kind, card, tenants,
                                             frozen)
        fallback0 = metrics.service_snapshot()["remote_planner_fallback"]
        # ---- controller ticks of every agent through the service -------
        ruled = [Rescheduler(client, agent, cfg, clock=client.clock,
                             recorder=client)
                 for _, cfg, client, agent, _ in tenants]
        records = [[] for _ in range(n)]
        tick_ms = []
        for _ in range(testing.SERVICE_TICKS):
            t0 = time.perf_counter()
            recs = together(lambda i: testing.tick_once(ruled[i],
                                                        tenants[i][2]))
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            for i, rec in enumerate(recs):
                records[i].append(rec)
        for (name, *_), recs in zip(tenants, records):
            check_records(name, recs, frozen[name])
        launches = dict(fk.LAUNCHES)
        batches = list(server.service.batch_log)[log0:]
        snap = metrics.service_snapshot()
        check(snap["remote_planner_fallback"] == fallback0,
              "an agent fell back to its local planner")
        check(snap["device_sick"] == 0
              and server.service.healthz_snapshot()["device"] != "sick",
              "the service marked the device sick")
        check(server.service.fatal is None, "the service ended")
    finally:
        for pool in pools:
            pool.close()
        server.close()

    single = [b for b in batches if b["horizon"] == 0]
    check(single and all(b["path"] == "device" for b in batches),
          "a batch was served off the card")
    for b in single:
        check(b["launches"].get("B1t") == 1 and b["launches"].get("B2t") == 1,
              f"a single-plan batch of {len(b['tenants'])} tenants launched "
              f"{b['launches']}, not one B1t and one B2t")
    widest = max(len(b["tenants"]) for b in single)
    check(widest >= 4, f"no batch carried 4 tenants (widest {widest})")
    check(launches["B1t"] == len(single) and launches["B2t"] == len(single),
          f"B1t/B2t launches {launches} != {len(single)} single-plan batches")
    log(f"[8] planner service on {health['solve_device']} "
        f"({health['batch_program']}), kernels built and loaded before it "
        f"listened ({ready_s:.2f} s); fleet of {n} tenants "
        f"({', '.join(names)}) generated in {gen_s:.1f} s, digests and "
        f"agent pack fingerprints == frozen, one bucket {bucket.key}")
    log(f"[8] every selection == the JAX service's; every {horizon}-step "
        f"schedule == the JAX service's; {testing.SERVICE_TICKS} controller "
        f"ticks a tenant through the service: every drain, evicted pod "
        f"UIDs and skip == the JAX package's agents' "
        f"({sum(len(r['evicted']) for rs in records for r in rs)} pods "
        f"evicted); remote_planner_fallback=0, service_device_sick=0; "
        f"{len(single)} single-plan batches (widest {widest} tenants), each "
        f"one B1t + one B2t launch; launches {launches}")
    for i, b in enumerate(batches):
        waits = b["queue_wait_ms"]
        since = (b["popped"] - max(t for t in released if t <= b["popped"])) * 1e3
        log(f"[8] batch {i + 1}: {len(b['tenants'])} tenants, horizon "
            f"{b['horizon']}, cut {since:.1f} ms after the fleet's "
            f"release from {b['queued']} waiting (cap {b['cap']}), queue wait {min(waits):.1f}-{max(waits):.1f} "
            f"ms, assemble {b['assemble_ms']:.2f} (of it delta scatter "
            f"{b['scatter_ms']:.2f}), upload {b['upload_ms']:.2f}, solve "
            f"{b['solve_ms']:.2f}, fetch {b['fetch_ms']:.3f}, reply "
            f"{b['reply_ms']:.3f} ms; launches {b['launches']} on {kind} "
            f"[{card}]")
    log(f"[8] per-tenant plan latency through the service (encode, POST, "
        f"queue, batch, decode; host clock): selections "
        f"{', '.join(f'{ms:.1f}' for _, ms in sel)} ms; schedules "
        f"{', '.join(f'{ms:.1f}' for _, ms in sched)} ms; controller ticks "
        f"of all {n} agents together {', '.join(f'{ms:.1f}' for ms in tick_ms)}"
        f" ms on {kind} [{card}]")

    # ---- the same plans solo, one TorchSolverPlanner, in this call -----
    packs = [t[4] for t in tenants]
    for staged in (256, 0):
        planner = TorchSolverPlanner(
            testing.service_config(ReschedulerConfig, spec0,
                                   staged_chunk_lanes=staged),
            device="cuda")
        saved = dict(fk.LAUNCHES)
        solo_ms = []
        for (name, *_), packed in zip(tenants, packs):
            t0 = time.perf_counter()
            got = planner.plan_packed(packed)
            solo_ms.append((time.perf_counter() - t0) * 1e3)
            want = frozen[name]["row"]
            check(got.found == bool(want[1]) and got.index == want[0]
                  and np.array_equal(got.row, want[3:]),
                  f"{name}: solo plan != the service's selection")
        fk.LAUNCHES.update(saved)
        log(f"[8] the same {n} plans solo by one TorchSolverPlanner "
            f"({'staged, early exit' if staged else 'unstaged'}): "
            f"{', '.join(f'{ms:.2f}' for ms in solo_ms)} ms (sum "
            f"{sum(solo_ms):.1f}); selections == the service's, on {kind} "
            f"[{card}]")

    # ---- B1t/B2t against plain and solo launches -----------------------
    host = stack_host(np, [buckets.pad_to_bucket(p, bucket) for p in packs])
    dev = to_device(host, "cuda")
    err = tenant_check(np, torch, fk, dev, "the batch's stack")
    pad = stack_host(np, [*(tenant_slice(host, t) for t in range(n)),
                          PackedCluster(*(np.zeros_like(f[0]) for f in host))])
    tenant_check(np, torch, fk, to_device(pad, "cuda"),
                 "the stack with a pad tenant")
    past = stack_host(np, [past_smem_pack(seed) for seed in range(3)])
    past_dev = to_device(past, "cuda")
    check(not fk.card_geometry(past_dev, True, stacked=True).lanes_in_smem,
          "the stacked past_smem_pack should carve its lanes from the "
          "workspace")
    tenant_check(np, torch, fk, past_dev, "past shared memory, T=3")
    log(f"[8] B1t and B2t bit-identical to their plain version and to {n} "
        f"solo B1/B2 launches (results and raw outputs) on the batch's "
        f"stack ({bucket.key}), on it with an all-invalid pad tenant "
        f"(T={n + 1}) and on past_smem_pack stacked T=3 (lanes in the "
        f"device-memory workspace)")
    saved = dict(fk.LAUNCHES)
    rows = {}
    raw_ff = fk.launch_tenants_raw(dev, False)[1].cpu().numpy()
    for name, bf, replaces, what in (
        ("B1t", False, "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:85",
         "first-fit over the tenant axis"),
        ("B2t", True, "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:156",
         "best-fit over the tenant axis"),
    ):
        nbytes = ops = 0
        for t in range(n):
            b_, o_ = ffd_work(np, tenant_slice(host, t),
                              None if bf else raw_ff[t], bf)
            nbytes, ops = nbytes + b_, ops + o_
        bound_ms, bound_by = work_bound(nbytes, ops)

        def kern(bf=bf):
            return fk.plan_ffd_tenants_kernel(dev, best_fit=bf)

        ms = time_ms(torch, kern)
        dev_ms = device_ms(torch, kern, FFD_KERNELS)
        plain_ms = time_ms(torch, lambda bf=bf: fk.plan_ffd_tenants_plain(
            dev, bf), reps=3, warmup=1)
        g = fk.card_geometry(dev, bf, stacked=True)
        rows[name] = dict(
            name=name, route="cuda",
            source="k8s_spot_rescheduler_tpu_torch/ops/csrc/ffd.cu",
            replaces=replaces, launches=launches[name], max_abs_err=err,
            ms=ms, device_ms=dev_ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            path="planner service batch (phase 8)",
        )
        log(f"[8] {name} ({what}, T={n}, {bucket.key}): {ms:.4f} ms a "
            f"wrapper call (CUDA events), {fmt_ms(dev_ms)} ms on the device "
            f"(profiler), {plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms "
            f"({bound_by}); {g.lanes_per_block} lanes x {g.warps_per_lane} "
            f"warps a block, {fk.grid_blocks(dev, g, bf, stacked=True)} "
            f"blocks a tenant x {n}; {launches[name]} launches on the "
            f"service's path, on {kind} [{card}]")
    fk.LAUNCHES.update(saved)
    cli_phase(here, kind, card)
    # phase 13 lays the same fleet over a tenant mesh
    fleet = (server_cfg, names, packs, [frozen[name]["row"] for name in names])
    return launches, rows, chaos_launches, fleet


def service_chaos_phase(np, fk, kind, card, tenants, frozen):
    """Phase 8 under the service fault layer: the fleet of
    ``service_phase`` (``tenants``: its fresh clusters, before their
    ticks) plans through a new ``ServiceServer`` on the card, every
    agent's transport under ``ServiceFaultPlan.profile("light", 0)``
    (``--service-chaos-profile light``). Released together, every
    selection must equal the no-chaos frozen answer (``frozen``; an
    agent that falls back plans on the numpy oracle, which gives the
    same rows). Then one agent drives the device-health watchdog through
    a scripted ``ServiceChaos``: a sick phase (extra solve latency on
    the service clock) must flip it (gauge, ``/healthz``, flight
    ``device-sick``) and one scripted solve error must fail its batch
    typed, not end the service; healthy probes on the card recover it.
    Then the fleet again. Zero agent crashes, the flight recorder's
    deltas equal the metrics', and no batch leaves the card. Returns the
    launches of this path (the caller's counts are restored)."""
    import threading

    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.service.agent import RemotePlanner
    from k8s_spot_rescheduler_tpu_torch.service.chaos import (
        ChaosAgentTransport,
        ServiceChaos,
        ServiceFaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.service.devhealth import (
        DeviceHealthWatchdog,
    )
    from k8s_spot_rescheduler_tpu_torch.service.server import ServiceServer
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    n = len(tenants)
    spec0 = CONFIGS[testing.SERVICE_TENANTS[0][1]]
    server = ServiceServer(
        testing.service_config(ReschedulerConfig, spec0,
                               service_resync_ingest_cap=n),
        "127.0.0.1:0", batch_window_s=0.25, device="cuda")
    server.start_background()
    svc = server.service
    url = f"http://{server.address}"
    f0, m0 = flight.RECORDER.counts(), metrics.service_snapshot()
    saved = dict(fk.LAUNCHES)
    fk.reset_launch_counts()
    log0 = len(svc.batch_log)
    crashes = []
    try:
        agents = []
        for name, cfg, client, _, _ in tenants:
            cfg = dataclasses.replace(
                cfg, planner_url=url, service_chaos_profile="light",
                service_chaos_seed=0)
            agent = RemotePlanner(cfg, tenant=name)
            check(isinstance(agent.transport, ChaosAgentTransport),
                  f"{name}: the agent's transport is not under chaos")
            store = client.columnar_store(
                cfg.resources, on_demand_label=cfg.on_demand_node_label,
                spot_label=cfg.spot_node_label)
            agents.append((name, agent, store, client.list_pdbs()))
        solvers = []

        def plan_check(i):
            name, agent, store, pdbs = agents[i]
            report = agent.plan(store, pdbs)
            want = frozen[name]["row"]
            got_found = report.plan is not None
            check(got_found == bool(want[1])
                  and report.n_feasible == want[2]
                  and (not got_found
                       or report.plan.candidate_index == want[0]),
                  f"{name}: selection under service chaos "
                  f"({report.solver}) != the no-chaos frozen answer")
            if got_found:
                _, meta = agent._pack_observation(store, pdbs)
                plan = meta.build_plan(want[0], np.asarray(want[3:]))
                check(dict(report.plan.assignments) == dict(plan.assignments),
                      f"{name}: assignments under service chaos != frozen")
            solvers.append(report.solver)

        def fleet_round():
            gate = threading.Barrier(n)

            def run(i):
                try:
                    gate.wait(timeout=60)
                    plan_check(i)
                except BaseException as err:  # noqa: BLE001 — reported below
                    crashes.append(err)

            threads = [threading.Thread(target=run, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            check(not crashes and all(not t.is_alive() for t in threads),
                  f"an agent crashed under service chaos: {crashes}")

        t0 = time.perf_counter()
        fleet_round()
        first_s = time.perf_counter() - t0
        # the watchdog choreography, one agent (one tenant a batch):
        # the shape's first solve, then the calibration samples
        for _ in range(2 * DeviceHealthWatchdog.CALIBRATION_BATCHES + 2):
            plan_check(0)
            if svc.healthz_snapshot()["device"] == "ok":
                break
        check(svc.healthz_snapshot()["device"] == "ok",
              "the watchdog did not calibrate")
        threshold = svc.config.device_sick_threshold
        svc.chaos = ServiceChaos(ServiceFaultPlan(
            seed=0, sick_phase=(1, threshold, 0.3),
            solve_error_script=(threshold + 1,)), clock=svc.clock)
        states, errors0 = [], m0["requests"].get("error", 0)
        for _ in range(40):
            plan_check(0)
            states.append(svc.healthz_snapshot()["device"])
            if svc.chaos.stats["solve_error"] and states[-1] == "ok":
                break
        check("sick" in states and states[-1] == "ok",
              f"the watchdog did not flip and recover: {states}")
        check(svc.chaos.stats["solve_error"] == 1
              and svc.chaos.stats["sick_latency"] == threshold,
              f"service chaos injected {dict(svc.chaos.stats)}")
        check(svc.fatal is None, "the scripted solve error ended the service")
        t0 = time.perf_counter()
        fleet_round()
        last_s = time.perf_counter() - t0
        m1, f1 = metrics.service_snapshot(), flight.RECORDER.counts()
    finally:
        server.close()
    launches = dict(fk.LAUNCHES)
    fk.LAUNCHES.update(saved)
    batches = list(svc.batch_log)[log0:]
    injected = {}
    for _, agent, _, _ in agents:
        for k, v in agent.transport.stats.items():
            injected[k] = injected.get(k, 0) + v

    def fdelta(kind_):
        return f1.get(kind_, 0) - f0.get(kind_, 0)

    fallback = m1["remote_planner_fallback"] - m0["remote_planner_fallback"]
    failover = m1["remote_planner_failover"] - m0["remote_planner_failover"]
    check(fdelta("remote-planner-fallback") == fallback
          and fdelta("failover") == failover
          and fdelta("device-sick") == 1 and fdelta("device-recovered") == 1
          and m1["device_sick"] == 0,
          f"flight deltas != metric deltas: fallback {fallback} / "
          f"{fdelta('remote-planner-fallback')}, failover {failover} / "
          f"{fdelta('failover')}, device-sick {fdelta('device-sick')}, "
          f"recovered {fdelta('device-recovered')}")
    check(batches and not [b for b in batches if b["path"] == "host"],
          "a batch was served off the card under service chaos")
    errors = int(m1["requests"].get("error", 0) - errors0)
    check(errors >= 1, "the scripted solve error failed no request")
    check(launches["B1t"] > 0 and launches["B2t"] > 0,
          f"B1t/B2t not launched under service chaos {launches}")
    log(f"[8] under the service fault layer (agents "
        f"--service-chaos-profile light, seed 0, on the fleet's fresh "
        f"clusters): every selection of {len(solvers)} plans == the "
        f"no-chaos frozen answer ({solvers.count('remote')} remote, "
        f"{solvers.count('remote-fallback')} local fallbacks); faults "
        f"injected on the agents {injected}; fleet rounds {first_s:.1f} / "
        f"{last_s:.1f} s; the sick phase ({threshold} batches +0.3 s) "
        f"flipped the watchdog and {DeviceHealthWatchdog.RECOVERY_PROBES} "
        f"healthy probes on the card recovered it ({' '.join(states)}); the "
        f"scripted solve error failed {errors} request(s) typed and the "
        f"service kept serving; 0 crashes; flight == metrics (fallback "
        f"{fallback}, failover {failover}, device-sick 1, recovered 1); "
        f"{len(batches)} batches, none on the host; launches {launches} "
        f"({len(batches)} batches) on "
        f"{kind} [{card}]")
    return launches


def chaos_phase(np, torch, fk, kind, card, here):
    """Phase 9: the controller on the card under the kube fault layer
    (``io/chaos``), against the JAX package's frozen runs
    (``data/chaos_seed0.json``): ``testing.CHAOS_RUNS`` through a
    ``ChaosClusterClient`` under ``FaultPlan.profile("heavy", 0)``, the
    mid-drain crash and its restart, both with ``TorchSolverPlanner`` on
    cuda, tick by tick (drain, evicted pod UIDs, skip, robustness
    counter deltas, faults injected), each tick's latency and split
    printed; then the CLI with ``testing.CHAOS_CLI_ARGS`` as a
    subprocess. The fallback planner counter must move as the JAX
    run's did (not at all): the fault layer breaks the client, not the
    planner. Returns the launches of the in-process runs."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.io.chaos import (
        ChaosClusterClient,
        FaultPlan,
    )
    from k8s_spot_rescheduler_tpu_torch.io.synthetic import (
        CONFIGS,
        generate_cluster,
    )
    from k8s_spot_rescheduler_tpu_torch.loop import flight
    from k8s_spot_rescheduler_tpu_torch.loop.controller import Rescheduler
    from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    frozen = testing.load_chaos()
    seed = frozen["seed"]
    fallback0 = metrics.robustness_snapshot()["planner_fallback"]
    want_fallbacks = sum(
        rec["counters"]["planner_fallback"]
        for run in [*frozen["runs"].values(), frozen["crash"]]
        for rec in run["records"])
    fk.reset_launch_counts()

    def timed(r, run, lines, seen_packs):
        tick = r.tick

        def timed_tick():
            t0 = time.perf_counter()
            res = tick()
            torch.cuda.synchronize()
            tick_ms = (time.perf_counter() - t0) * 1e3
            trace = (flight.last_tick() or {}).get("trace", {})
            seen_packs.extend(sp.get("attrs", {}).get("source") for sp in
                              walk_spans(trace) if sp["name"] == "plan.pack")
            lines.append(tick_line(9, run, len(lines) + 1, tick_ms, trace,
                                   list(res.drained))
                         + (f" (skipped {res.skipped})" if res.skipped
                            else ""))
            return res

        r.tick = timed_tick
        return r

    for name, config_id, ticks in testing.CHAOS_RUNS:
        want = frozen["runs"][name]
        spec = CONFIGS[config_id]
        client = generate_cluster(spec, seed, reschedule_evicted=True)
        check(testing.cluster_digest(client) == want["digest"],
              f"{name}: generated cluster digest != frozen")
        cfg = testing.controller_config(ReschedulerConfig, spec,
                                        testing.CHAOS_HORIZON, "columnar")
        planner = TorchSolverPlanner(cfg, device="cuda")
        seen = testing.track_observations(planner)
        chaos = ChaosClusterClient(client, FaultPlan.profile("heavy", seed),
                                   clock=client.clock)
        lines, packs = [], []
        r = timed(Rescheduler(chaos, planner, cfg, clock=client.clock,
                              recorder=chaos), name, lines, packs)
        records = testing.chaos_ticks(r, chaos, ticks,
                                      metrics.robustness_snapshot)
        for line in lines:
            log(line + f" on {kind} [{card}]")
        for i, (got, exp) in enumerate(zip(records, want["records"])):
            check(got == exp, f"{name} tick {i + 1}: {got} != the JAX "
                              f"package's {exp}")
        check(len(records) == len(want["records"]), f"{name}: tick count")
        stats = dict(sorted(chaos.stats.items()))
        check(stats == want["stats"],
              f"{name}: faults injected {stats} != the JAX run's "
              f"{want['stats']}")
        check(set(seen) <= {"NodeMap"} and set(packs) <= {"objects"},
              f"{name}: chaos did not force the object path ({set(seen)})")
        log(f"[9] {name} (config {config_id}, {ticks} ticks, heavy, seed "
            f"{seed}, objects): every tick's drain, evicted pod UIDs, skip "
            f"and counter deltas == the JAX package's; faults {stats} == "
            f"the JAX run's on {kind} [{card}]")

    want = frozen["crash"]
    spec = CONFIGS[testing.CRASH_CONFIG]
    client = generate_cluster(spec, seed, reschedule_evicted=True)
    check(testing.cluster_digest(client) == want["digest"],
          "crash: generated cluster digest != frozen")
    cfg = testing.controller_config(ReschedulerConfig, spec,
                                    testing.CHAOS_HORIZON, "columnar")
    chaos = ChaosClusterClient(client, FaultPlan(seed=seed,
                                                 interrupt_on_taint=1),
                               clock=client.clock)
    lines, packs = [], []
    t0 = time.perf_counter()
    got = testing.crash_run(
        client, chaos,
        lambda c: timed(Rescheduler(c, TorchSolverPlanner(cfg, device="cuda"),
                                    cfg, clock=client.clock, recorder=c),
                        "crash", lines, packs),
        testing.CRASH_TICKS, metrics.robustness_snapshot)
    crash_s = time.perf_counter() - t0
    for line in lines:
        log(line + f" on {kind} [{card}]")
    for key in ("crashed", "orphaned", "evicted_before_restart", "healed",
                "tainted_after_restart"):
        check(got[key] == want[key],
              f"crash: {key} {got[key]} != the JAX package's {want[key]}")
    for i, (g, w) in enumerate(zip(got["records"], want["records"])):
        check(g == w, f"crash: restarted tick {i + 1} {g['drained']} != the "
                      f"JAX package's {w['drained']}")
    check(len(got["records"]) == len(want["records"]), "crash: tick count")
    log(f"[9] mid-drain crash (config {testing.CRASH_CONFIG}, "
        f"interrupt_on_taint=1): ChaosInterrupt after tainting "
        f"{got['orphaned']}, nothing evicted; the restarted controller "
        f"healed {got['healed']} orphaned taint at start-up and drained "
        f"{[rec['drained'] for rec in got['records']]} == the JAX "
        f"package's ({crash_s:.1f} s in all) on {kind} [{card}]")
    launches = dict(fk.LAUNCHES)
    fallbacks = metrics.robustness_snapshot()["planner_fallback"] - fallback0
    check(fallbacks == want_fallbacks,
          f"the fallback planner ran {fallbacks} times, the JAX runs "
          f"{want_fallbacks}")
    check(launches["B1"] > 0 and launches["B2"] > 0,
          f"B1/B2 not launched under the kube fault layer {launches}")

    want = frozen["cli"]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
         *testing.CHAOS_CLI_ARGS],
        cwd=here, env=dict(os.environ, PYTHONPATH=here), capture_output=True,
        text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"chaos CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    ticks = re.findall(r"(tick \d+: .*)$", proc.stderr, re.M)
    check(ticks == want["ticks"],
          f"chaos CLI ticked {ticks}, the JAX package's CLI {want['ticks']}")
    fallback_lines = re.findall(r"planner_fallback_total=(\d+)", proc.stderr)
    check(fallback_lines == ["0"],
          f"chaos CLI planner_fallback_total {fallback_lines}")
    log(f"[9] python -m k8s_spot_rescheduler_tpu_torch "
        f"{' '.join(testing.CHAOS_CLI_ARGS)}: exit 0 in {cli_s:.1f} s, "
        f"{' | '.join(ticks)} == the JAX package's CLI, "
        f"planner_fallback_total=0; in-process launches {launches}, "
        f"planner_fallback {fallbacks} == the JAX runs' on {kind} [{card}]")
    return launches


def cli_phase(here, kind, card):
    """``--serve`` and an agent CLI with ``--planner-url`` on config 1:
    the agent drains as the frozen JAX CLI run, with no tick on its
    local fallback; SIGTERM drains the service to exit 0."""
    import signal
    import socket
    import urllib.request

    from k8s_spot_rescheduler_tpu_torch import testing

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    serve = subprocess.Popen(
        [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch", "--serve",
         f"127.0.0.1:{port}", "--no-metrics-server"],
        cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True,
    )
    try:
        while True:
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    health = json.loads(r.read())
                break
            except OSError:
                check(serve.poll() is None and time.perf_counter() - t0 < 300,
                      "--serve did not come up")
                time.sleep(0.2)
        up_s = time.perf_counter() - t0
        check("B1t/B2t" in health["batch_program"],
              f"--serve /healthz names {health['batch_program']}")
        t0 = time.perf_counter()
        agent = subprocess.run(
            [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
             *testing.CLI_ARGS, "--planner-url", f"http://127.0.0.1:{port}",
             "--planner-timeout", "120s"],
            cwd=here, env=env, capture_output=True, text=True, timeout=600,
        )
        agent_s = time.perf_counter() - t0
    finally:
        serve.send_signal(signal.SIGTERM)
        try:
            out, _ = serve.communicate(timeout=60)
        except subprocess.TimeoutExpired:
            serve.kill()
            out, _ = serve.communicate()
    check(agent.returncode == 0,
          f"agent CLI exited {agent.returncode}: {agent.stderr[-2000:]}")
    drained = re.findall(r"tick \d+: drained=(\[.*?\])", agent.stderr)
    want = [repr(rec["drained"]) for rec in testing.load_ticks()["cli"]["records"]]
    check(drained == want, f"agent CLI drained {drained}, the JAX CLI {want}")
    fallbacks = re.findall(r"remote_planner_fallback_total=(\d+)",
                           agent.stderr)
    check(fallbacks == ["0"], f"agent CLI remote_planner_fallback_total "
                              f"{fallbacks}")
    check(serve.returncode == 0,
          f"--serve exited {serve.returncode} on SIGTERM: {out[-2000:]}")
    log(f"[8] python -m k8s_spot_rescheduler_tpu_torch --serve: up in "
        f"{up_s:.1f} s ({health['batch_program']}), exit 0 on SIGTERM; "
        f"agent {' '.join(testing.CLI_ARGS)} --planner-url: exit 0 in "
        f"{agent_s:.1f} s, drained {', '.join(drained)} == the JAX "
        f"package's CLI run, remote_planner_fallback_total=0, on {kind} "
        f"[{card}]")


def busy_share(path: str) -> dict:
    """The device's busy share of a ``utils/tracing.device_trace``
    Chrome trace: the summed durations of its kernel, memcpy and memset
    events over the traced window (the first event's start to the last
    one's end)."""
    with open(path) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and "dur" in e]
    check(events, f"{path}: no events in the trace")
    start = min(e["ts"] for e in events)
    window = max(e["ts"] + e["dur"] for e in events) - start
    device = [e for e in events
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    busy = sum(e["dur"] for e in device)
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "share": busy / window if window > 0 else 0.0,
            "kernels": sum(e.get("cat") == "kernel" for e in device),
            "copies": sum(e.get("cat") != "kernel" for e in device)}


def bench_drive(fk, phase: int, total: dict, kind, card, tag, *argv,
                kernels=("B1", "B2"), planner_fallbacks=0,
                remote_fallbacks=0, ok=True, devices=None):
    """One run of the port's bench driver (``python -m
    k8s_spot_rescheduler_tpu_torch.bench``, by its ``run``, over
    ``devices``: every visible card when None) on the card in phase
    ``phase``, with the launch counts set to 0 just before and read
    just after: each of ``kernels`` must have launched, the row's
    launches must equal the counters, its attestation must name the card
    with the device not sick at the end, and its planner and
    remote-planner fallbacks must be the expected ones. The run must exit
    0 unless ``ok`` is False (the caller then holds the exit code). The
    row's JSON is printed on its own line and its launches added to
    ``total``. Returns (exit code, row, wall seconds, launches)."""
    from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench

    fk.reset_launch_counts()
    t0 = time.perf_counter()
    rc, row = bench.run(["--device", "cuda", *argv], devices=devices)
    wall = time.perf_counter() - t0
    launches = dict(fk.LAUNCHES)
    print(json.dumps(bench.drop_non_finite(row)), flush=True)
    if ok:
        why = (row.get("error") or row.get("failures")
               or row.get("violations"))
        check(rc == 0, f"[{phase}] bench {tag}: exit {rc}: {why}")
    check(all(launches[k] > 0 for k in kernels),
          f"[{phase}] bench {tag}: {kernels} did not all launch: {launches}")
    check(row["launches"] == launches,
          f"[{phase}] bench {tag}: the row's launches {row['launches']} != "
          f"the counters {launches}")
    att = row["backend_attestation"]
    check(att["solve_backend"] == f"cuda/{kind}"
          and att.get("nvidia_smi") == card,
          f"[{phase}] bench {tag}: attestation {att} does not name {kind} "
          f"[{card}]")
    check(att["planner_fallbacks"] == planner_fallbacks
          and att["remote_planner_fallbacks"] == remote_fallbacks
          and not att["device_sick"],
          f"[{phase}] bench {tag}: fallback counters {att} (want "
          f"{planner_fallbacks} planner and {remote_fallbacks} agent "
          f"fallbacks, the device not sick)")
    for k in total:
        total[k] += launches[k]
    return rc, row, wall, launches


def guard_drive(fk, phase: int, total: dict, kind, card, tag, devices,
                kernels=("B1", "B2"), absent=()):
    """The bench's latency mode past one device's memory: the frozen case
    ``tag`` of ``data/bench_seed0.json`` "guard" (the root ``bench.py``'s
    ``_run_latency`` on the JAX package under the same budget: the keys
    that name the program it ran, its scale note and its selection) run
    by ``bench_drive`` over ``devices`` with ``--repeats 3``, its budget
    forced on ``solver/memory.device_hbm_budget`` for the run. The row's
    keys, scale note and selection must equal the frozen ones, each of
    ``kernels`` must have launched and none of ``absent``. The repair
    passes of the run (``solver/repair.plan_repair`` and
    ``plan_repair_chunked`` calls, and B5's launches) are counted.
    Returns (row, launches, wall seconds, repair passes)."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.solver import memory, repair

    case = testing.load_bench()["guard"][tag]
    check(case["devices"] == len(devices),
          f"[{phase}] guard {tag}: frozen over {case['devices']} devices")
    argv = ["--config", str(case["config"]), "--repeats", "3"]
    if case["solver"] != "torch":
        argv += ["--solver", case["solver"]]
    passes = [0]
    saved = (memory.device_hbm_budget, repair.plan_repair,
             repair.plan_repair_chunked)

    def counted(fn):
        def wrapped(*args, **kwargs):
            passes[0] += 1
            return fn(*args, **kwargs)
        return wrapped

    memory.device_hbm_budget = lambda device=None: case["budget"]
    repair.plan_repair = counted(saved[1])
    repair.plan_repair_chunked = counted(saved[2])
    try:
        _, row, wall, launches = bench_drive(
            fk, phase, total, kind, card, f"--config {case['config']} "
            f"(guard {tag})", *argv, kernels=kernels, devices=devices)
    finally:
        (memory.device_hbm_budget, repair.plan_repair,
         repair.plan_repair_chunked) = saved
    keys = {k: row.get(k) for k in testing.GUARD_KEYS}
    check(keys == case["keys"],
          f"[{phase}] guard {tag}: keys {keys} != the JAX package's "
          f"{case['keys']}")
    note = case["scale_note"].replace("single-chip", "single-device")
    check(row.get("scale_note") == note,
          f"[{phase}] guard {tag}: scale_note {row.get('scale_note')!r} != "
          f"{note!r}")
    check(row["selection"] == case["selection"],
          f"[{phase}] guard {tag}: selection {row['selection'][:3]} != the "
          f"JAX package's {case['selection'][:3]}")
    check(not any(launches[k] for k in absent),
          f"[{phase}] guard {tag}: {absent} launched: {launches}")
    return row, launches, wall, passes[0] + launches["B5"]


def guard_line(row, launches, wall, kind, card) -> str:
    return (f"tier {row['tier']}, solver {row['solver']}, carry_chunks "
            f"{row['carry_chunks']}, carry_bytes {row['carry_bytes']}, "
            f"repair_unavailable {row['repair_unavailable']}; selection "
            f"idx={row['first_candidate']} n_feasible={row['n_feasible']}; "
            f"all == the JAX package's (data/bench_seed0.json \"guard\"); "
            f"solve+fetch {row['value']:.3f} ms (median of 3), device-only "
            f"{row['device_only']['device_only_ms']} ms; launches "
            f"{ {k: v for k, v in launches.items() if v} }; {wall:.1f} s, "
            f"on {kind} [{card}]")


def watchdog_check(here) -> str:
    """``python -m k8s_spot_rescheduler_tpu_torch.bench --config 3
    --repeats 10000 --watchdog 5`` on the card must exit 3 printing one
    line, the error row that names the watchdog. The repeats hold the run
    past 5 s however fast the host: a warm config-3 run takes ~4 s, its
    10,000 solves alone ~5.6 s."""
    argv = [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch.bench",
            "--config", "3", "--repeats", "10000", "--watchdog", "5"]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=here, env=dict(os.environ,
                                                   PYTHONPATH=here),
                          capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    want = {"metric": "drain_plan_ms_config3_50kpods_5knodes",
            "value": None, "unit": "ms", "vs_baseline": None,
            "error": "watchdog: bench exceeded 5s budget"}
    check(proc.returncode == 3 and len(lines) == 1
          and json.loads(lines[0]) == want,
          f"[10] bench --watchdog 5: exit {proc.returncode}, stdout "
          f"{proc.stdout[-600:]!r}, stderr {proc.stderr[-600:]!r}")
    return (f"[10] python -m k8s_spot_rescheduler_tpu_torch.bench "
            f"{' '.join(argv[3:])}: exit 3 after {wall:.1f} s with one line, "
            f"the watchdog's error row {lines[0]}")


def mesh_guard_phase(fk, total: dict, kind, card, devices) -> None:
    """Phase 13's bench rows past the budget: the latency mode at the
    cand, cand-carry and 2-D (``--solver sharded``) rungs' forced budgets
    over ``devices``, each held against the JAX package's frozen row."""
    for tag, kernels in (("cand", ("B1", "B2")), ("cand-carry", ("B3", "B4")),
                         ("2d", ())):
        # the 2-D rung runs no greedy kernel; its union may repair with B5
        absent = tuple(k for k in fk.LAUNCHES if k != "B5")
        row, launches, wall, _ = guard_drive(
            fk, 13, total, kind, card, tag, devices, kernels=kernels,
            absent=absent if tag == "2d" else ())
        log(f"[13] bench {row['metric']} past rung {tag}'s forced budget "
            f"over {len(devices)} x cuda:0: "
            + guard_line(row, launches, wall, kind, card))


def bench_phase(np, torch, fk, kind, card, here):
    """Phase 10: the port's bench driver (``python -m
    k8s_spot_rescheduler_tpu_torch.bench``, by its ``run`` function) on
    the card in every mode it has, each with the launch counts set to 0
    just before and read just after: B1 and B2 must have launched in
    each, every row's attestation must name the card with no planner or
    remote-planner fallback, and every count, drain, evicted-pod digest,
    ILP value and chain-depth counter must equal the JAX package's
    (``data/bench_seed0.json``); the latency rows' selections equal the
    frozen ``config3_seed0.npz``/``config4_seed0.npz`` answers. One
    config-3 run goes with ``--trace-dir``: the device's busy share of
    its timed window comes from the Chrome trace. Each row's JSON is
    printed on its own line. Returns B1, B2 and B5's launches over the
    phase."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench
    from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz

    frozen = testing.load_bench()
    data = os.path.join(here, "k8s_spot_rescheduler_tpu_torch", "data")
    total = {"B1": 0, "B2": 0, "B5": 0}

    drive = functools.partial(bench_drive, fk, 10, total, kind, card)

    # ---- latency, configs 3 and 4 (and config 3 traced) --------------
    lat = {}
    for config_id in (3, 4):
        _, ans = load_npz(os.path.join(data, f"config{config_id}_seed0.npz"))
        _, row, wall, launches = drive(f"--config {config_id}", "--config",
                                       str(config_id))
        check(row["selection"] == ans["selection"].tolist(),
              f"[10] bench --config {config_id}: selection "
              f"{row['selection'][:3]} != frozen {ans['selection'][:3]}")
        lat[config_id] = row
        dev = row["device_only"]
        log(f"[10] bench --config {config_id} ({row['metric']}): generate "
            f"{row['generate_s']:.2f} s, pack {row['pack_ms']:.3f} ms "
            f"(median of 5), upload {row['upload_ms']:.3f} ms, solve+fetch "
            f"{row['value']:.3f} ms (median of 10, min "
            f"{row['solve_fetch_ms_min']:.3f}), with upload "
            f"{row['with_upload_ms']:.3f} ms, full tick "
            f"{row['full_tick_ms']:.3f} ms, steady incremental tick "
            f"{row['steady_tick_ms']:.3f} ms, device-only "
            f"{dev['device_only_ms']} ms (chain of {dev['chain_len']}: "
            f"{dev['chain_ms']} ms, floor {dev['rtt_ms']} ms); feasible "
            f"{row['n_feasible']}/{row['candidates']}, first candidate "
            f"{row['first_candidate']} == frozen; tier {row['tier']}; "
            f"launches {launches}; {wall:.1f} s, on {kind} [{card}]")
    trace_dir = os.path.join(here, "chiprun_out", "bench_traces")
    _, row, wall, _ = drive("--config 3 --trace-dir", "--config", "3",
                            "--trace-dir", trace_dir)
    check(row.get("trace_file") and os.path.exists(row["trace_file"]),
          "[10] bench --config 3 --trace-dir wrote no trace")
    check(row["selection"] == lat[3]["selection"],
          "[10] traced config-3 selection != untraced")
    share = busy_share(row["trace_file"])
    check(share["kernels"] > 0, "[10] the trace holds no kernel event")
    log(f"[10] bench --config 3 --trace-dir: solve+fetch {row['value']:.3f} "
        f"ms traced against {lat[3]['value']:.3f} ms untraced; device busy "
        f"{share['busy_ms']:.3f} ms ({share['kernels']} kernels, "
        f"{share['copies']} copies) of a {share['window_ms']:.3f} ms traced "
        f"window (10 solve+fetch calls): busy share "
        f"{share['share']:.4f}; trace "
        f"{os.path.relpath(row['trace_file'], here)}, on {kind} [{card}]")

    # ---- past one device's memory, and the watchdog -----------------
    row, launches, wall, passes = guard_drive(
        fk, 10, total, kind, card, "one-device", [torch.device("cuda", 0)],
        absent=("B3", "B4"))
    check(passes == 0, f"[10] guard one-device: {passes} repair passes")
    log(f"[10] bench --config 3 past a forced one-device budget "
        f"({row['scale_note']}): first-fit ∪ best-fit without repair, "
        f"B1 and B2 launched, no B3/B4, no repair pass; "
        + guard_line(row, launches, wall, kind, card))
    log(watchdog_check(here))

    # ---- the replays ---------------------------------------------------
    for tag, argv, want in (
        ("--config 5", ("--config", "5", "--events",
                        str(testing.BENCH_REPLAY_EVENTS)),
         frozen["replay"]["replay"]),
        ("--config 5 --constrained",
         ("--config", "5", "--constrained", "--events",
          str(testing.BENCH_CONSTRAINED_EVENTS)),
         frozen["replay"]["constrained"]),
    ):
        check(want["events"] == int(argv[-1]), f"{tag}: frozen events")
        _, row, wall, launches = drive(tag, *argv)
        stats = row["stats"]
        got = {k: stats[k] for k in want["stats"]}
        check(got == want["stats"],
              f"[10] bench {tag}: {got} != the JAX package's {want['stats']}")
        check(stats["stranded_by_drain"] == 0,
              f"[10] bench {tag}: stranded {stats['stranded_by_drain']}")
        log(f"[10] bench {tag} --events {want['events']} ({row['metric']}): "
            f"replan p50 {row['value']:.3f} ms, p99 "
            f"{row['replan_ms_p99']:.3f} ms over {stats['ticks']} ticks; "
            f"{int(stats['interruptions'])} interruptions, "
            f"{int(stats['displaced_pods'])} displaced pods, "
            f"{int(stats['drained_nodes'])} drained, stranded 0; every "
            f"count == the JAX package's; launches {launches}; {wall:.1f} s, "
            f"on {kind} [{card}]")

    # ---- quality and the boundary ---------------------------------------
    for tag, group, variants in (("--quality", "quality", ("ffd", "shipped")),
                                 ("--quality-boundary", "boundary",
                                  ("shipped",))):
        _, row, wall, launches = drive(tag, f"--{tag[2:]}")
        want_rows = frozen["quality"][group]
        check(sorted(row["rows"]) == sorted(f"{n}/0" for n in want_rows),
              f"[10] bench {tag}: configs {sorted(row['rows'])}")
        parts = []
        for name, want in want_rows.items():
            got = row["rows"][f"{name}/0"]
            check(got["ilp"] == want["ilp"],
                  f"[10] {tag} {name}: ILP {got['ilp']} != {want['ilp']}")
            for v in variants:
                check(got[v] == want[v]
                      and got[f"{v}_evictions"] == len(want[f"{v}_evictions"])
                      and got[f"{v}_evictions_sha256"]
                      == bench.evictions_digest(want[f"{v}_evictions"]),
                      f"[10] {tag} {name} {v}: {got[v]} drains != the JAX "
                      f"package's {want[v]} (or its evictions differ)")
            parts.append(f"{name} ILP {got['ilp']} " + " ".join(
                f"{v} {got[v]} ({got[f'{v}_ratio']:.3f}, "
                f"{got[f'{v}_s']:.2f} s)" for v in variants)
                + f" [ILP {got['ilp_s']:.2f} s]")
        log(f"[10] bench {tag} ({row['metric']} = {row['value']}): "
            f"{'; '.join(parts)}; every ILP, drain count and eviction list "
            f"== the JAX package's; launches {launches}; {wall:.1f} s, on "
            f"{kind} [{card}]")

    # ---- chain depth -------------------------------------------------------
    _, row, wall, launches = drive("--chain-depth", "--chain-depth",
                                   "--events",
                                   str(testing.BENCH_CONSTRAINED_EVENTS))
    for side in ("organic", "control"):
        check(row[side] == frozen["chain"][side],
              f"[10] bench --chain-depth {side}: {row[side]} != the JAX "
              f"package's {frozen['chain'][side]}")
    check(row["control_deeper"] > 0, "[10] chain3 control: no deeper lane")
    log(f"[10] bench --chain-depth ({row['metric']} = {row['value']}, "
        f"control deeper {row['control_deeper']}): organic {row['organic']}; "
        f"control {row['control']}; == the JAX package's counters; "
        f"launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- quality at scale ---------------------------------------------------
    want = frozen["scale"]
    _, row, wall, launches = drive(
        "--quality-scale", "--quality-scale", "--config", str(want["config"]),
        "--scale", str(want["scale"]))
    for key in ("bound", "achieved", "fetches_total", "schedule_lens",
                "evictions", "evictions_sha256"):
        check(row[key] == want[key],
              f"[10] bench --quality-scale {key}: {row[key]} != the JAX "
              f"package's {want[key]}")
    log(f"[10] bench --quality-scale --config {want['config']} --scale "
        f"{want['scale']} ({row['metric']} = {row['value']}): {row['achieved']} "
        f"of bound {row['bound']} (LP {row['bound_s']:.2f} s), "
        f"{row['fetches_total']} fetches <= {row['fetch_bound']}, "
        f"{len(row['schedule_lens'])} schedule cuts, drains "
        f"{row['sched_wall_s']:.1f} s; bound, drains, fetches, schedule "
        f"lengths and evictions == the JAX package's; launches {launches}; "
        f"{wall:.1f} s, on {kind} [{card}]")
    return total


CARRY_KEYS = ("carry_chunks", "carry_plane_bytes", "feasible_lanes",
              "valid_lanes", "bucket")


def bench_modes_phase(np, torch, fk, kind, card, here):
    """Phase 11: the root ``bench.py``'s single-device modes in the port's
    bench (by its ``run``), on the card, each with the launch counts set to 0
    just before and read just after, the attestation naming the card,
    and every count equal to the JAX package's frozen rows
    (``data/bench_seed0.json``): ``--replay-device-only`` on the frozen
    harvested tick (a copy of ``data/replay_harvest_seed0.npz`` through
    ``--harvest-cache``: its selection and feasible lanes; B1, B2 and
    B5 must launch), ``--carry-wall`` on config 3 at 4 chunks and at the ladder's
    count (feasible and valid lanes, chunk count, plane bytes, bucket
    key; B3 and B4 must launch), ``--smoke`` (the first full pack's
    bytes, the steady tick's delta lanes and staged chunks; every delta
    smaller than the full pack; the row ``ok`` with ``verify_protocol_ms``
    > 0: the proto tier, ``python -m tools.analysis --tier proto
    k8s_spot_rescheduler_tpu_torch``, ran green in its own process),
    ``--pallas-smoke`` (no mismatch, B1 and
    B4 launched on each pack), ``--chaos`` and ``--watch-soak`` at 300
    ticks (every stat, no violation; the chaos soak's two scripted
    planner crashes are its only planner fallbacks). Each row's JSON on
    its own line. Returns B1-B5's launches over the phase."""
    import shutil

    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench

    frozen = testing.load_bench()
    total = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B5": 0}

    drive = functools.partial(bench_drive, fk, 11, total, kind, card)

    # ---- --replay-device-only on the frozen harvested tick -------------
    want = frozen["harvest"]
    cache = os.path.join(here, "build", "bench_modes",
                         "replay_harvest_seed0.npz")
    os.makedirs(os.path.dirname(cache), exist_ok=True)
    shutil.copyfile(testing.HARVEST_PATH, cache)
    _, row, wall, launches = drive("--replay-device-only",
                                   "--replay-device-only", "--harvest-cache",
                                   cache, kernels=("B1", "B2", "B5"))
    for key in ("selection", "feasible", "unproven", "bf_only",
                "tick_shape"):
        check(row[key] == want[key],
              f"[11] --replay-device-only {key}: {row[key]} != the JAX "
              f"package's {want[key]}")
    dev = row["device_only"]
    log(f"[11] bench --replay-device-only ({row['metric']}): the constrained "
        f"replay's tick at {want['events']} events, C={want['tick_shape']['C']} "
        f"K={want['tick_shape']['K']} S={want['tick_shape']['S']}, "
        f"{want['unproven']} greedy-unproven lanes ({row['note']}): "
        f"device-only {row['value']:.3f} ms a union solve (chain of "
        f"{dev['chain_len']}: {dev['chain_ms']} ms, floor {dev['rtt_ms']} ms), "
        f"first call {row['first_call_s']:.2f} s; selection (first "
        f"{row['selection'][0]}, {row['feasible']} feasible) == the JAX "
        f"package's; launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --carry-wall on config 3, pinned and the ladder's count -------
    # (both rows also go to CARRY_ROWS: phase 12's --twin-calibration)
    carry = frozen["carry"]
    rows_path = os.path.join(here, CARRY_ROWS)
    if os.path.exists(rows_path):
        os.remove(rows_path)
    for key, extra in (("pinned", ("--carry-chunks",
                                   str(testing.BENCH_CARRY_CHUNKS))),
                       ("ladder", ())):
        tag = f"--carry-wall --config {carry['config']} {' '.join(extra)}"
        _, row, wall, launches = drive(tag.strip(), "--carry-wall", "--config",
                                       str(carry["config"]), *extra,
                                       kernels=("B3", "B4"))
        with open(rows_path, "a") as f:
            f.write(json.dumps(bench.drop_non_finite(row)) + "\n")
        got = {k: row[k] for k in CARRY_KEYS}
        check(got == carry[key], f"[11] bench {tag}: {got} != the JAX "
              f"package's {carry[key]}")
        log(f"[11] bench {tag.strip()} ({row['metric']}): union wall "
            f"{row['value']:.3f} ms (median of {row['repeats']}, min "
            f"{row['wall_ms_min']:.3f}), first call {row['compile_s']:.2f} s, "
            f"{row['carry_chunks']} chunks of layout "
            f"{'/'.join(row['carry_layout'])} ({row['carry_plane_bytes']} B a "
            f"lane-spot); {row['feasible_lanes']}/{row['valid_lanes']} lanes "
            f"feasible, bucket {row['bucket']} == the JAX package's; launches "
            f"{launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --smoke ---------------------------------------------------------
    want = frozen["smoke"]
    _, row, wall, launches = drive("--smoke", "--smoke")
    ups = row["upload_bytes"]
    check(ups[0] == want["upload_bytes"][0],
          f"[11] --smoke: first full pack {ups[0]} B != the JAX package's "
          f"{want['upload_bytes'][0]} B")
    check(all(0 < u < ups[0] for u in ups[1:]),
          f"[11] --smoke: a delta tick is not smaller than the full pack: "
          f"{ups}")
    for key in ("delta_pack_lanes", "chunks_solved", "chunks_skipped"):
        check(row[key] == want[key][-1], f"[11] --smoke {key}: {row[key]} "
              f"!= the JAX package's {want[key][-1]}")
    # the proto tier (the port's protocol model explored and bound to its
    # wire, agent and server) ran green in a subprocess of the smoke
    check(row["ok"] and row.get("verify_protocol_ms", 0) > 0,
          f"[11] --smoke: ok {row['ok']}, verify_protocol_ms "
          f"{row.get('verify_protocol_ms')}")
    log(f"[11] bench --smoke ({row['metric']} = {row['value']}): uploads per "
        f"tick {ups} B (the JAX package's, its delta sections padded to "
        f"powers of two: {want['upload_bytes']} B), steady tick "
        f"{row['steady_tick_ms']:.3f} ms (plan.solve span "
        f"{row['span_solve_ms']:.3f} ms), chunks {row['chunks_solved']} "
        f"solved / {row['chunks_skipped']} skipped == the JAX package's; "
        f"proto tier green, verify_protocol_ms {row['verify_protocol_ms']}; "
        f"launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --pallas-smoke --------------------------------------------------
    want = frozen["smoke"]["pallas"]
    _, row, wall, launches = drive("--pallas-smoke", "--pallas-smoke",
                                   kernels=("B1", "B4"))
    check(row["mismatches"] == want["mismatches"] == []
          and row["checks"] == want["checks"]
          and row["chunk_counts"] == want["chunk_counts"],
          f"[11] --pallas-smoke: {row['mismatches']} ({row['checks']} checks)")
    check(row["kernels"] == ["B1", "B4"]
          and launches["B4"] == launches["B1"] == row["cases"],
          f"[11] --pallas-smoke: kernels {row['kernels']}, launches {launches}")
    log(f"[11] bench --pallas-smoke ({row['metric']} = {row['value']}): "
        f"{row['cases']} packs, {row['checks']} checks: B4 == plain streamed "
        f"best-fit at chunk counts {row['chunk_counts']} == the best-fit "
        f"oracle, B1 == the first-fit oracle, 0 mismatches as the JAX "
        f"package's; launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --chaos and --watch-soak ----------------------------------------
    n = str(frozen["soak"]["ticks"])
    want = frozen["soak"]["chaos"]
    _, row, wall, launches = drive("--chaos", "--chaos", "--chaos-ticks", n,
                                   planner_fallbacks=2)
    got = {k: row.get(k) for k in want}
    check(got == want, f"[11] --chaos: {got} != the JAX package's {want}")
    log(f"[11] bench --chaos --chaos-ticks {n} ({row['metric']} = "
        f"{row['value']}): {row['drains']} drains ({row['drains_after_quiesce']} "
        f"after quiesce), {row['injected_faults']} injected faults, "
        f"{row['mid_drain_interrupts']} mid-drain restart, "
        f"{row['planner_fallback_ticks']} scripted planner crashes contained, "
        f"{row['flight_breaker_engagements']} breaker engagements, "
        f"{row['flight_dumps']} flight dumps, 0 orphaned taints; every stat "
        f"== the JAX package's; soak {row['wall_s']:.2f} s; launches "
        f"{launches}; on {kind} [{card}]")
    want = frozen["soak"]["watch"]
    _, row, wall, launches = drive("--watch-soak", "--watch-soak",
                                   "--watch-soak-ticks", n)
    check(not want["violations"] and "violations" not in row,
          f"[11] --watch-soak violations: {row.get('violations')}")
    got = {k: row.get(k) for k in want["stats"]}
    check(got == want["stats"],
          f"[11] --watch-soak: {got} != the JAX package's {want['stats']}")
    log(f"[11] bench --watch-soak --watch-soak-ticks {n} ({row['metric']} = "
        f"{row['value']}): {row['drains']} drains, {row['stalls_detected']} "
        f"stalls, {row['relists']} relists, {row['resync_audits']} audits, "
        f"drift healed in {row['drift_heal_seconds']} s, "
        f"{row['freshness_bypass_ticks']} bypassed ticks, "
        f"{row['full_lists']} LISTs, mirror parity {row['mirror_parity']}; "
        f"every stat == the JAX package's; soak {row['wall_s']:.2f} s; "
        f"launches {launches}; on {kind} [{card}]")
    return total


CARRY_ROWS = os.path.join("build", "bench_modes", "carry_wall.jsonl")
# the reference's one fleet-twin check a threaded run's timing decides
# (its heavier phase's queue-wait p99 above the lighter one's): printed,
# not held
P99_ORDER = "degenerate queue-wait curve"
# the service buckets the fleet twin's size tiers land in
TWIN_BUCKETS = ("C8xK8xS8xR2xW1xA2", "C8xK16xS8xR2xW1xA2")


def service_modes_phase(np, torch, fk, kind, card, here):
    """Phase 12: the root ``bench.py``'s service-side modes in the port's
    bench (by its ``run``) on the card, each with the launch counts set to
    0 just before and read just after and the attestation naming the
    card, against the JAX package's frozen rows (``data/bench_seed0.json``
    parts ``serve``, ``sched``, ``fleet``, ``edges``):

    - ``--serve-smoke``: the solo selections and lanes, the full, quiet,
      churn and resync ticks' wire bytes, the resyncs, the applied deltas
      and the pooled reuses (100 + 25 ticks, as frozen) equal; no
      mismatch, no fallback, the trace trees whole, a batch of two
      tenants or more (B1t/B2t launch); the pooled-vs-fresh wall race of
      its ``reuse_ok`` is printed, not held;
    - ``--sched-smoke``: drains, fetches, bound, schedule lengths,
      invalidations and the schedule cut equal, no violation;
    - ``--fleet-chaos``: every count equal, the agents' 5 scripted local
      fallbacks and 18 failovers included, but ``recovered_after_ticks``
      1 and ``ticks`` 27 (JAX 2 and 28): no batch leaves the card while
      it is sick, so the first two batches after the sick phase are both
      healthy probes;
    - ``--carry-wall --config 1``: its bucket is one the twins land in
      (B4 and a first-fit kernel launch); its row joins phase 11's
      carry-wall rows as the table ``--fleet-twin-smoke
      --twin-calibration`` reads, which must charge some batches that
      measured cost;
    - ``--fleet-twin-smoke`` and ``--storm-smoke``: no crash, no
      mismatch, every ledger equal, the shed edges' per-reason deltas
      equal. Each prints its ``host_split``: where the host's wall went.

    Each row's JSON on its own line. Returns the phase's launches."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench

    frozen = testing.load_bench()
    total = {k: 0 for k in fk.LAUNCHES}

    drive = functools.partial(bench_drive, fk, 12, total, kind, card)

    # ---- --serve-smoke -------------------------------------------------
    want = frozen["serve"]
    rc, row, wall, launches = drive("--serve-smoke", "--serve-smoke",
                                    kernels=("B1", "B2", "B1t", "B2t"),
                                    ok=False)
    for key in ("selections", "solo_lanes", "full_tick_bytes",
                "quiet_tick_bytes", "churn_tick_bytes", "resync_tick_bytes",
                "delta_applied", "delta_resyncs", "wire_reuse",
                "wire_reconnects", "wire_pooled_conns", "remote_fallbacks",
                "mismatches", "delta_mismatches", "trace_violations",
                "wire_ok", "reuse_ticks", "fresh_ticks"):
        check(row[key] == want[key], f"[12] --serve-smoke {key}: {row[key]} "
              f"!= the JAX package's {want[key]}")
    check(row["reuse_counts_ok"] and row["batch_tenants_max"] >= 2
          and row["batch_lanes_max"] > max(row["solo_lanes"]),
          f"[12] --serve-smoke: reuse counts {row['reuse_counts_ok']}, "
          f"batch tenants {row['batch_tenants_max']}, lanes "
          f"{row['batch_lanes_max']} (solo {row['solo_lanes']})")
    check(rc == (0 if row["reuse_ok"] else 1) and (
        row["ok"] == row["reuse_ok"]),
          f"[12] --serve-smoke: exit {rc} with reuse_ok {row['reuse_ok']}")
    log(f"[12] bench --serve-smoke ({row['metric']} = {row['value']} ms, the "
        f"median agent plan of the first tick through the 0.5 s window): "
        f"{row['n_tenants']} tenants, batch of {row['batch_tenants_max']} "
        f"tenants / {row['batch_lanes_max']} lanes; spans queue "
        f"{row['span_queue_ms']} solve {row['span_solve_ms']} wire "
        f"{row['span_wire_ms']} ms; wire bytes full {row['full_tick_bytes']} "
        f"quiet {row['quiet_tick_bytes']} churn {row['churn_tick_bytes']} "
        f"resync {row['resync_tick_bytes']}, {row['delta_applied']} deltas "
        f"applied, {row['delta_resyncs']} resyncs, {row['wire_reuse']} pooled "
        f"reuses: every count and selection == the JAX package's; "
        f"wire.request pooled {row['span_wire_pooled_ms']} ms vs fresh "
        f"{row['span_wire_fresh_ms']} ms (reuse_ok {row['reuse_ok']}, exit "
        f"{rc}); launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --sched-smoke -------------------------------------------------
    want = dict(frozen["sched"])
    rc, row, wall, launches = drive("--sched-smoke", "--sched-smoke")
    check(not want.pop("violations") and "violations" not in row,
          f"[12] --sched-smoke violations: {row.get('violations')}")
    got = {k: row[k] for k in want}
    check(got == want, f"[12] --sched-smoke: {got} != the JAX package's")
    log(f"[12] bench --sched-smoke ({row['metric']} = {row['value']}): "
        f"{row['drains']} drains in {row['fetches_total']} fetches (bound "
        f"{row['fetch_bound']}), schedule lens {row['schedule_lens']}, "
        f"{row['invalidations']} invalidation, the {len(row['schedule_cut'])}"
        f"-step cut over the wire == the local cut; every count == the JAX "
        f"package's; {row['failovers']} failover with a schedule in flight; "
        f"launches {launches}; {wall:.1f} s, on {kind} [{card}]")

    # ---- --fleet-chaos -------------------------------------------------
    want = dict(frozen["fleet"])
    named = {"recovered_after_ticks": (1, 2), "ticks": (27, 28)}
    rc, row, wall, launches = drive("--fleet-chaos", "--fleet-chaos",
                                    remote_fallbacks=want["fallbacks"])
    for key, (port, jax) in named.items():
        check((row[key], want[key]) == (port, jax),
              f"[12] --fleet-chaos {key}: {row[key]} (the JAX package's "
              f"{want[key]}; want {port} on the card)")
    for key in ("n_agents", "sick_detect_ticks", "sick_detect_batches",
                "failovers", "fallbacks", "delta_resyncs", "corrupt_resyncs",
                "half_close_strikes", "half_close_reconnects",
                "flight_eq_metrics", "flight_deltas", "selections",
                "primary_back", "device_end_state", "crashes", "mismatches"):
        check(row[key] == want[key], f"[12] --fleet-chaos {key}: {row[key]} "
              f"!= the JAX package's {want[key]}")
    check(row["warmed_bucket_keys"] == want["warmed_buckets"],
          f"[12] --fleet-chaos warmed {row['warmed_bucket_keys']}")
    log(f"[12] bench --fleet-chaos ({row['metric']} = {row['value']} ms, the "
        f"median agent tick while replica A is down): {row['ticks']} ticks, "
        f"sick after {row['sick_detect_batches']} batches, recovered after "
        f"{row['recovered_after_ticks']} tick (the JAX package's 2: no host "
        f"path on the card), {row['failovers']} failovers, "
        f"{row['fallbacks']} local fallbacks, {row['half_close_strikes']} "
        f"half-close strikes / {row['half_close_reconnects']} reconnects, "
        f"{row['delta_resyncs']} resyncs, warmed {row['warmed_bucket_keys']}; "
        f"every other count == the JAX package's; launches {launches}; "
        f"{wall:.1f} s, on {kind} [{card}]")

    # ---- the fleet twin ------------------------------------------------
    edges = frozen["edges"]

    def twin_checks(tag, row):
        check(row["crashes"] == 0 and row["mismatches"] == [],
              f"[12] {tag}: crashes {row['crashes']}, mismatches "
              f"{row['mismatches']}")
        held = [f for f in row["failures"] if not f.startswith(P99_ORDER)]
        check(held == [], f"[12] {tag}: {held}")
        if "shed_edge_metric_delta" in row:
            check(row["shed_edge_metric_delta"] == edges["metric_delta"]
                  and row["shed_edge_flight_delta"] == edges["flight_delta"],
                  f"[12] {tag}: shed edges {row['shed_edge_metric_delta']} / "
                  f"{row['shed_edge_flight_delta']} != the JAX package's "
                  f"{edges['metric_delta']}")
        return [f for f in row["failures"] if f.startswith(P99_ORDER)]

    def curve(row):
        return " / ".join(
            f"{r['active_twins']} twins: occupancy {r['occupancy']}, p99 "
            f"{r['queue_wait_p99_ms']} ms" for r in row["capacity_curve"])

    def split(row):
        s = row["host_split"]
        return (f"host {s['wall_ms_per_batch']} ms a batch over "
                f"{s['batches']} batches (loop {s['loop_s']} s; a tick: "
                f"encode {s['tick_encode_ms']}, post {s['tick_post_ms']} ms; "
                f"a batch: solve {s['solve_ms_per_batch']} ms, medians "
                f"{s['batch_ms_median']}; a request: "
                f"{s['request_ms_median']})")

    # a carry-wall row at the bucket most twins land in (config 1's 3+3
    # nodes, 20 pods: C8xK16xS8), beside phase 11's config-3 rows
    _, row, wall, launches = drive("--carry-wall --config 1", "--carry-wall",
                                   "--config", "1", kernels=())
    check(launches["B1"] + launches["B3"] > 0 and launches["B4"] > 0,
          f"[12] --carry-wall --config 1: no first-fit or no B4: {launches}")
    check(row["bucket"] in TWIN_BUCKETS, f"[12] --carry-wall --config 1: "
          f"bucket {row['bucket']} is not a twin's {TWIN_BUCKETS}")
    cal = os.path.join(here, CARRY_ROWS)
    with open(cal, "a") as f:
        f.write(json.dumps(bench.drop_non_finite(row)) + "\n")
    log(f"[12] bench --carry-wall --config 1 ({row['metric']}): union wall "
        f"{row['value']:.3f} ms (median of {row['repeats']}), bucket "
        f"{row['bucket']}, {row['carry_chunks']} chunks; launches "
        f"{launches}; {wall:.1f} s, on {kind} [{card}]")
    rc, row, wall, launches = drive(
        "--fleet-twin-smoke", "--fleet-twin-smoke", "--twin-calibration", cal,
        kernels=("B1", "B2", "B1t", "B2t"), ok=False)
    p99 = twin_checks("--fleet-twin-smoke", row)
    check(rc == (1 if p99 else 0), f"[12] --fleet-twin-smoke: exit {rc}")
    check(row["calibrated_batches"] > 0,
          "[12] --fleet-twin-smoke: no batch was charged a carry-wall cost")
    log(f"[12] bench --fleet-twin-smoke --twin-calibration ({row['metric']} "
        f"= {row['value']}): {row['ever_active']} twins x {row['replicas']} "
        f"replicas, {row['sim_s']} s simulated in {row['wall_s']} s; "
        f"{curve(row)}; jain {row['jain_fleet']}; {row['verified_selections']} "
        f"spot checks == a solo TorchSolverPlanner; {row['failovers']} "
        f"failovers; restart storm {row['resync_storm']}; "
        f"{row['calibrated_batches']} batches charged a carry-wall cost; shed "
        f"edges == the JAX package's; p99 order: {p99 or 'held'}; "
        f"{split(row)}; launches {launches}; {wall:.1f} s, on {kind} [{card}]")
    rc, row, wall, launches = drive(
        "--storm-smoke", "--storm-smoke",
        kernels=("B1", "B2", "B1t", "B2t"), ok=False)
    p99 = twin_checks("--storm-smoke", row)
    check(rc == (1 if p99 else 0), f"[12] --storm-smoke: exit {rc}")
    log(f"[12] bench --storm-smoke ({row['metric']} = {row['value']}): "
        f"{row['n_twins']} twins, {row['sim_s']} s simulated in "
        f"{row['wall_s']} s; restart storm {row['resync_storm']}; "
        f"{row['verified_selections']} spot checks; shed edges == the JAX "
        f"package's; p99 order: {p99 or 'held'}; {split(row)}; launches "
        f"{launches}; {wall:.1f} s, on {kind} [{card}]")
    return total


SCALE_KEYS = ("carry_chunks", "carry_bytes", "repair_chunks",
              "repair_unavailable", "narrow_carry_chunks", "lane_block",
              "est_device_gb", "budget_gb", "breakdown_mb")


def selection_of(np, sel):
    return np.concatenate([[sel.index, int(sel.found), sel.n_feasible],
                           sel.row])


def one_layout(packs):
    """The carry layout every pack proves (``solver/carry.carry_layout``),
    or the wide layout where they differ."""
    from k8s_spot_rescheduler_tpu_torch.solver.carry import (
        WIDE_LAYOUT,
        carry_layout,
    )

    layouts = {carry_layout(p) for p in packs}
    return layouts.pop() if len(layouts) == 1 else WIDE_LAYOUT


def mesh_phase(np, torch, fk, kind, card, here, fleet):
    """Phase 13: the mesh tiers on one card named ``SHARDED_DEVICES``
    times (see the module docstring). Returns the launches of its main
    paths."""
    from k8s_spot_rescheduler_tpu_torch import testing
    from k8s_spot_rescheduler_tpu_torch.models.tensors import (
        load_npz,
        to_device,
    )
    from k8s_spot_rescheduler_tpu_torch.parallel.mesh import (
        make_cand_mesh,
        make_mesh,
        make_tenant_mesh,
    )
    from k8s_spot_rescheduler_tpu_torch.parallel.sharded_ffd import (
        plan_ffd_sharded,
        plan_union_cand_sharded,
    )
    from k8s_spot_rescheduler_tpu_torch.parallel.tenant_batch import (
        make_tenant_batch_planner,
    )
    from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.service import buckets
    from k8s_spot_rescheduler_tpu_torch.service.server import PlannerService
    from k8s_spot_rescheduler_tpu_torch.solver.carry import carry_layout
    from k8s_spot_rescheduler_tpu_torch.solver.fallback import (
        with_best_fit_fallback,
    )
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    n = testing.SHARDED_DEVICES
    devices = [torch.device("cuda", 0)] * n
    host3, ans = load_npz(testing.SHARDED_PATH)
    check(int(ans["devices"]) == n, "the frozen mesh size differs")
    total = {k: 0 for k in fk.LAUNCHES}
    want_launches = {  # one launch a lane block of each of the path's kernels
        "cand": {"B1": n, "B2": n}, "cand-chunked": {"B1": n, "B2": n},
        "cand-carry": {"B3": n, "B4": n}, "2d": {},
    }

    def launches_ok(launches, tier) -> bool:
        """The tier's greedy launches, and B5 only where its union's
        repair is unchunked (cand and 2d: at most one a lane block)."""
        used = {k: v for k, v in launches.items() if v and k != "B5"}
        b5 = launches.get("B5", 0)
        return used == want_launches[tier] and (
            b5 <= n if tier in ("cand", "2d") else b5 == 0)

    def drive(fn):
        """fn() with the launch counts set to 0 just before, read just
        after; returns (result, launches)."""
        fk.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        launches = dict(fk.LAUNCHES)
        for k in total:
            total[k] += launches[k]
        return out, launches

    def rung(tag, host, key, tier, mesh_shape):
        cfg = ReschedulerConfig(solver_hbm_budget=int(ans[f"{key}_budget"]),
                                mesh_shape=tuple(mesh_shape))
        planner = TorchSolverPlanner(cfg, device="cuda", devices=devices)
        t0 = time.perf_counter()
        sel, launches = drive(lambda: planner.plan_packed(host))
        first_s = time.perf_counter() - t0
        check(np.array_equal(selection_of(np, sel), ans[f"{key}_selection"]),
              f"[13] {tag}: selection {selection_of(np, sel)[:3]} != the "
              f"JAX package's {ans[f'{key}_selection'][:3]}")
        dispatch = ans[f"{key}_dispatch"].tolist()
        label = str(ans[f"{key}_label"]).replace("jax", "torch", 1)
        check(planner.last_dispatch == (label, bool(dispatch[0]),
                                        *dispatch[1:]),
              f"[13] {tag}: dispatch {planner.last_dispatch} != the JAX "
              f"package's ({label}, {dispatch})")
        used = {k: v for k, v in launches.items() if v}
        check(launches_ok(launches, tier),
              f"[13] {tag}: launches {used}, want {want_launches[tier]}")
        reps = 3 if tier == "2d" else 10
        ms = time_ms(torch, lambda: planner.plan_packed(host), reps=reps,
                     warmup=1)
        return (f"{tag}: {label} (repair_dropped={dispatch[0]}, "
                f"repair_chunks={dispatch[1]}, carry_chunks={dispatch[2]}, "
                f"carry_bytes={dispatch[3]}), selection idx={sel.index} "
                f"n_feasible={sel.n_feasible} == the JAX package's; first "
                f"call {first_s * 1e3:.1f} ms, {ms:.3f} ms a call (median of "
                f"{reps}, CUDA events); launches {used or 'none (torch ops)'}")

    # ---- config 3's controller pack through every rung ------------------
    C3, K3, _ = host3.slot_req.shape
    for name, tier, mesh_shape in testing.SHARDED_RUNGS:
        log(f"[13] config 3 (C={C3} K={K3} S={host3.spot_free.shape[0]}), "
            + rung(f"rung {name}", host3, f"config3_{name}", tier, mesh_shape)
            + f", over {n} x cuda:0 on {kind} [{card}]")

    # ---- the contended pack and the harvested tick ----------------------
    data = os.path.join(here, "k8s_spot_rescheduler_tpu_torch", "data")
    sources = {"contended": os.path.join(data, "contended_seed0.npz"),
               "harvest": testing.HARVEST_PATH}
    for pack in testing.SHARDED_PACKS:
        host, _ = load_npz(sources[pack])
        for name, tier, mesh_shape in testing.SHARDED_PACK_RUNGS:
            key = f"{pack}_{name}"
            line = rung(f"{pack} rung {name}", host, key, tier, mesh_shape)
            if tier == "2d":
                solve = with_best_fit_fallback(functools.partial(
                    plan_ffd_sharded, make_mesh(tuple(mesh_shape), devices)))
            else:
                solve = functools.partial(
                    plan_union_cand_sharded, make_cand_mesh(devices),
                    rounds=8, carry_chunks=STREAM_CHUNKS[-1],
                    carry_layout=carry_layout(host), use_kernel=True)
            res, launches = drive(lambda: solve(host))
            check(np.array_equal(res.feasible.cpu().numpy(),
                                 ans[f"{key}_feasible"])
                  and np.array_equal(res.assignment.cpu().numpy(),
                                     ans[f"{key}_assignment"]),
                  f"[13] {pack} {name}: lanes != the JAX package's")
            check(launches_ok(launches, tier),
                  f"[13] {pack} {name}: launches {launches}")
            log(f"[13] {pack} (C={host.slot_req.shape[0]} "
                f"K={host.slot_req.shape[1]} S={host.spot_free.shape[0]}), "
                f"{line}; lanes ({int(res.feasible.sum())} feasible) == the "
                f"JAX package's on {kind} [{card}]")

    # ---- the service stack over a tenant mesh ----------------------------
    server_cfg, names, packs, rows = fleet
    bucket = buckets.bucket_for(packs[0])
    for T in (len(names), 6):
        svc = PlannerService(server_cfg, batch_window_s=0,
                             max_batch_tenants=len(names), device="cuda",
                             devices=devices)
        reqs = [svc.submit_nowait(name, p)
                for name, p in zip(names[:T], packs[:T])]
        t0 = time.perf_counter()
        _, batch_launches = drive(svc.drain_once)
        batch_ms = (time.perf_counter() - t0) * 1e3
        for name, req, want in zip(names, reqs, rows):
            r = req.reply
            check(req.error is None and r is not None
                  and [r.index, int(r.found), r.n_feasible,
                       *np.asarray(r.row).tolist()] == want,
                  f"[13] tenant mesh T={T}: {name}'s reply != the JAX "
                  f"service's")
        b = svc.batch_log[-1]
        check(b["tenants"] == names[:T] and b["path"] == "device",
              f"[13] tenant mesh T={T}: batch {b['tenants']} on {b['path']}")
        check(batch_launches["B1t"] == n and batch_launches["B2t"] == n,
              f"[13] tenant mesh T={T}: launches {batch_launches}, want one "
              f"B1t and one B2t a block")
        padded = svc._pad_tenant_axis(buckets.stack_bucket(
            [buckets.pad_to_bucket(p, bucket) for p in packs[:T]], bucket))
        dev = to_device(padded, "cuda")
        one = make_tenant_batch_planner(None, rounds=8)(dev)[:T]
        layout = one_layout(packs[:T])
        mesh_rows = {}
        for chunks in (0, 4):
            planner = make_tenant_batch_planner(
                make_tenant_mesh(devices), rounds=8, carry_chunks=chunks,
                carry_layout=layout if chunks else None)
            out, mesh_rows[chunks] = drive(lambda: planner(dev))
            check(torch.equal(out[:T], one)
                  and out[:T].cpu().numpy().tolist() == rows[:T],
                  f"[13] tenant mesh T={T} carry_chunks={chunks}: rows != "
                  f"the one-device batch / the JAX service's")
        check(mesh_rows[4]["B3"] == padded.slot_req.shape[0]
              and mesh_rows[4]["B4"] == padded.slot_req.shape[0],
              f"[13] tenant mesh T={T} carry tier: launches {mesh_rows[4]}")
        ms = time_ms(torch, lambda: make_tenant_batch_planner(
            make_tenant_mesh(devices), rounds=8)(dev), reps=10, warmup=1)
        one_ms = time_ms(torch, lambda: make_tenant_batch_planner(
            None, rounds=8)(dev), reps=10, warmup=1)
        log(f"[13] tenant mesh of {n} x cuda:0, T={T} (padded to "
            f"{padded.slot_req.shape[0]}, {bucket.key}): drain_once "
            f"{batch_ms:.1f} ms, every reply == the JAX service's "
            f"(data/service_seed0.json), batch log names the {T} tenants, "
            f"{batch_launches['B1t']} B1t + {batch_launches['B2t']} B2t "
            f"(one a block); "
            f"the mesh batch {ms:.3f} ms against one device {one_ms:.3f} ms a "
            f"call (CUDA events), rows == the one-device batch; carry tier "
            f"(carry_chunks=4, layout {'/'.join(layout)}): rows equal, "
            f"{mesh_rows[4]['B3']} B3 + {mesh_rows[4]['B4']} B4 (one a "
            f"tenant) on {kind} [{card}]")

    # ---- the CLI ----------------------------------------------------------
    frozen_cli = json.loads(str(ans["cli"]))
    argv = [sys.executable, "-m", "k8s_spot_rescheduler_tpu_torch",
            *testing.SHARDED_CLI_ARGS]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=here, env=dict(os.environ,
                                                   PYTHONPATH=here),
                          capture_output=True, text=True, timeout=600)
    cli_s = time.perf_counter() - t0
    check(proc.returncode == 0,
          f"[13] sharded CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    drained = re.findall(r"tick \d+: drained=(\[.*?\])", proc.stderr)
    want = [repr(rec["drained"]) for rec in frozen_cli["records"]]
    check(drained == want, f"[13] sharded CLI drained {drained}, the JAX "
                           f"package's CLI {want}")
    fallbacks = re.findall(r"planner_fallback_total=(\d+)", proc.stderr)
    check(fallbacks == ["0"],
          f"[13] sharded CLI planner_fallback_total {fallbacks}")
    log(f"[13] python -m k8s_spot_rescheduler_tpu_torch "
        f"{' '.join(testing.SHARDED_CLI_ARGS)}: exit 0 in {cli_s:.1f} s, "
        f"drained {', '.join(drained)} == the JAX package's CLI with the "
        f"same flags, planner_fallback_total=0, on {kind} [{card}]")

    # ---- the bench's latency rows past the budget -------------------------
    mesh_guard_phase(fk, total, kind, card, devices)

    # ---- --scale-smoke ----------------------------------------------------
    frozen = json.loads(str(ans["scale_smoke"]))
    _, row, wall, _ = bench_drive(fk, 13, total, kind, card,
                                  "--scale-smoke", "--scale-smoke",
                                  kernels=())
    for key in SCALE_KEYS:
        check(row[key] == frozen[key],
              f"[13] --scale-smoke {key} {row[key]} != the JAX package's "
              f"{frozen[key]}")
    log(f"[13] bench --scale-smoke ({row['metric']} = {row['value']}): "
        f"{', '.join(f'{k} {row[k]}' for k in SCALE_KEYS[:-1])} == the JAX "
        f"package's; B3/B4 launch geometries at the {row['lane_block']}-"
        f"lane block: " + "; ".join(
            f"{lay} B3 {g['B3']['lanes_per_block']}x"
            f"{g['B3']['warps_per_lane']} warps {g['B3']['smem_bytes']} B, "
            f"B4 {g['B4']['lanes_per_block']}x{g['B4']['warps_per_lane']} "
            f"warps {g['B4']['smem_bytes']} B"
            for lay, g in row["geometry"].items()))
    log("[13] one card named several times: every rung's kernels ran, "
        "block by block; multi-GPU concurrency and peer copies were not run")
    return total


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
        TorchSolverPlanner,
    )
    from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd
    from k8s_spot_rescheduler_tpu_torch.solver.schedule import commit_step_host
    from k8s_spot_rescheduler_tpu_torch.testing import random_pack
    from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    t_start = time.perf_counter()
    t_phase = [t_start]

    def phase_done(name):
        now = time.perf_counter()
        log(f"[time] phase {name}: {now - t_phase[0]:.1f} s (at "
            f"{now - t_start:.1f} s)")
        t_phase[0] = now

    # ---- phase 1: card and build --------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] device: {kind} | nvidia-smi: {card} | "
        f"device_count={torch.cuda.device_count()} | torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    lib_paths = fk.build()
    lib = fk.library()
    stream_lib = fk.library("stream_bf")
    repair_lib = fk.library("repair")
    build_s = time.perf_counter() - t0
    log(f"[1] kernel build {build_s:.2f} s (one nvcc per source, in "
        f"parallel) -> "
        f"{', '.join(os.path.relpath(p, here) for p in lib_paths.values())}; "
        f"max dynamic smem B1/B2 {lib.ffd_max_dynamic_smem(0)} B, "
        f"B4 {stream_lib.stream_bf_max_dynamic_smem(0)} B, "
        f"B5 {repair_lib.repair_max_dynamic_smem(0)} B")
    for part in re.split(r"(?=^\[\w+\] )", fk.BUILD_LOG, flags=re.M):
        regs = [int(n) for n in re.findall(r"Used (\d+) registers", part)]
        spills = [int(n) for n in re.findall(r"(\d+) bytes spill stores",
                                             part)]
        if regs:
            log(f"[1] ptxas {part.split()[0]}: {len(regs)} kernel instances, "
                f"{min(regs)}-{max(regs)} registers, at most "
                f"{max(spills, default=0)} B of spill stores")

    phase_done("1 (card, build)")
    data = os.path.join(here, "k8s_spot_rescheduler_tpu_torch", "data")
    host3, ans3 = load_npz(os.path.join(data, "config3_seed0.npz"))
    host4, ans4 = load_npz(os.path.join(data, "config4_seed0.npz"))
    hostc, ansc = load_npz(os.path.join(data, "contended_seed0.npz"))
    dev3 = to_device(host3, "cuda")
    C, K, R = host3.slot_req.shape
    S = host3.spot_free.shape[0]
    log(f"[2] config 3 pack: C={C} K={K} S={S} R={R} "
        f"W={host3.spot_taints.shape[1]} A={host3.spot_aff.shape[1]}; "
        f"B1 {geometry_line(fk, dev3, False)}; "
        f"B2 {geometry_line(fk, dev3, True)}")

    # ---- phase 2: kernels against their plain versions ----------------
    rng = np.random.default_rng(0)
    for i in range(24):
        shape = (
            (int(rng.integers(1, 40)), int(rng.integers(1, 9)),
             int(rng.integers(1, 700)), int(rng.integers(1, 5)))
            if i < 20 else (300, 32, 9000 if i == 23 else 2560 + 37 * i, 4)
        )
        host = random_pack(rng, *shape)
        dev = to_device(host, "cuda")
        for bf in (False, True):
            check(same(torch, fk.plan_ffd_kernel(dev, best_fit=bf),
                       plan_ffd(dev, best_fit=bf)) == 0,
                  f"random pack {i} {shape}: kernel best_fit={bf} != plain")
        if shape[2] == 9000:
            check(not fk.card_geometry(dev, True).statics_in_smem,
                  "the S=9000 pack should read its statics from device memory")
        chunk = max(1, shape[2] // 3)
        b3 = b3_once(torch, fk, dev, chunk)
        check(same(torch, b3, fk.plan_ffd_chunked_plain(dev, chunk)) == 0,
              f"random pack {i}: B3 != its plain chunk loop")
        check(same(torch, b3, plan_ffd(dev)) == 0,
              f"random pack {i}: B3 != plain first-fit")
    torch.cuda.synchronize()
    log("[2] 24 seeded random packs (the last, S=9000, with the statics "
        "read from device memory): B1, B2, B3 bit-identical to the plain "
        "versions")
    stress = overlay_phase(np, torch, fk)
    log(f"[2] {len(stress)} overlay-stress packs ({', '.join(stress)}): B1 "
        f"and B2 raw outputs, results and B3 bit-identical to the plain "
        f"versions")
    log(chunk_phase(np, torch, fk))
    for line in past_smem_phase(np, torch, fk):
        log(line)

    plain_ff = plan_ffd(dev3)
    plain_bf = plan_ffd(dev3, best_fit=True)
    b1 = fk.plan_ffd_kernel(dev3)
    b2 = fk.plan_ffd_kernel(dev3, best_fit=True)
    b3_chunk = -(-S // STREAM_CHUNKS[-1])  # the streamed union's chunks
    b3 = b3_once(torch, fk, dev3, b3_chunk)
    b3_plain = fk.plan_ffd_chunked_plain(dev3, b3_chunk)
    err1 = same(torch, b1, plain_ff)
    err2 = same(torch, b2, plain_bf)
    err3 = max(same(torch, b3, b3_plain), same(torch, b3, b1))
    check(err1 == 0, "config 3: B1 != plain first-fit")
    check(err2 == 0, "config 3: B2 != plain best-fit")
    check(err3 == 0, "config 3: B3 != plain chunk loop / unchunked B1")
    _, raw_ff = fk.launch_raw(dev3, False)
    raw_ff = raw_ff.cpu().numpy()
    log(f"[2] config 3: B1, B2, B3 (Sc={b3_chunk}) bit-identical to plain; "
        f"feasible lanes ff={int(b1.feasible.sum())} bf={int(b2.feasible.sum())}"
        f"; B3 {geometry_line(fk, dev3, False, spot_chunk=b3_chunk)}")

    specs = [
        ("B1", "first-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:85",
         lambda: fk.plan_ffd_kernel(dev3), lambda: plan_ffd(dev3), err1,
         ffd_bound(np, host3, raw_ff, False)),
        ("B2", "best-fit", "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:156",
         lambda: fk.plan_ffd_kernel(dev3, best_fit=True),
         lambda: plan_ffd(dev3, best_fit=True), err2,
         ffd_bound(np, host3, None, True)),
        ("B3", f"first-fit over spot chunks of {b3_chunk}",
         "k8s_spot_rescheduler_tpu/ops/pallas_ffd.py:351",
         lambda: fk.plan_ffd_chunked(dev3, b3_chunk),
         lambda: fk.plan_ffd_chunked_plain(dev3, b3_chunk), err3,
         ffd_bound(np, host3, raw_ff, False)),
    ]
    timings = {}
    for name, what, replaces, kern, plain, err, (bound_ms, bound_by) in specs:
        ms = time_ms(torch, kern)
        dev_ms = device_ms(torch, kern, FFD_KERNELS)
        plain_ms = time_ms(torch, plain, reps=5, warmup=1)
        timings[name] = dict(
            name=name, what=what, route="cuda",
            source="k8s_spot_rescheduler_tpu_torch/ops/csrc/ffd.cu",
            replaces=replaces, max_abs_err=err, ms=ms, device_ms=dev_ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=None,
        )
        log(f"[2] {name} ({what}): {ms:.4f} ms a wrapper call (CUDA "
            f"events), {fmt_ms(dev_ms)} ms on the device (profiler), "
            f"{plain_ms:.4f} ms plain, bound {bound_ms:.6f} ms ({bound_by}) "
            f"on {kind} [{card}]")

    phase_done("2 (kernels against plain)")
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

    fused = TorchSolverPlanner(ReschedulerConfig(staged_chunk_lanes=0),
                               device="cuda")
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
    chunk_calls = {
        "B1": lambda: fk.plan_ffd_kernel(chunk3),
        "B2": lambda: fk.plan_ffd_kernel(chunk3, best_fit=True),
        "B3": lambda: fk.plan_ffd_chunked(chunk3, b3_chunk),
    }
    log(f"[3] kernels on the 256-lane chunk at {lo}, ms a wrapper call "
        f"(CUDA events) / device ms (profiler): "
        + ", ".join(f"{k} {time_ms(torch, fn):.4f} / "
                    f"{fmt_ms(device_ms(torch, fn, FFD_KERNELS))}"
                    for k, fn in chunk_calls.items())
        + f" (B1 {geometry_line(fk, chunk3, False)}; "
        f"B2 {geometry_line(fk, chunk3, True)}) on {kind} [{card}]")
    n_geo = geometry_check(torch, fk, dev3) + geometry_check(torch, fk, chunk3)
    log(f"[3] {n_geo} launch geometries on all lanes and on the chunk: B1/B2 "
        f"bit-identical to the default geometry")

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

    phase_done("3 (the planning tick)")
    log(contended_phase(np, torch, fk, hostc, ansc, kind, card))
    repair_lines, timings["B5"] = repair_phase(np, torch, fk, hostc, kind,
                                               card)
    for line in repair_lines:
        log(line)
    phase_done("4 (contended, B5)")
    stream_launches = stream_phase(
        np, torch, fk, timings, kind, card,
        (("config 3", host3, ans3), ("config 4", host4, ans4),
         ("contended", hostc, ansc)),
    )

    phase_done("5 (streamed union)")
    tick_launches, tick_timings = controller_phase(
        np, torch, fk, kind, card, here)
    # B1/B2's row: the path whose launches it counts, timed on its pack
    timings.update(tick_timings)
    phase_done("6 (controller)")
    kube_launches = kube_phase(np, torch, fk, kind, card, here)
    phase_done("7 (kube path)")
    service_launches, service_rows, service_chaos_launches, fleet = (
        service_phase(np, torch, fk, kind, card, here))
    phase_done("8 (planner service)")
    chaos_launches = chaos_phase(np, torch, fk, kind, card, here)

    phase_done("9 (controller under chaos)")
    bench_launches = bench_phase(np, torch, fk, kind, card, here)
    phase_done("10 (bench)")
    modes_launches = bench_modes_phase(np, torch, fk, kind, card, here)
    phase_done("11 (bench modes)")
    fleet_launches = service_modes_phase(np, torch, fk, kind, card, here)
    phase_done("12 (service-side bench modes)")
    mesh_launches = mesh_phase(np, torch, fk, kind, card, here, fleet)
    phase_done("13 (mesh tiers)")
    # the main path: the controller tick observing through the mirror,
    # fed by the fake cluster (phase 6) and by the watch (phase 7)
    mirror = {k: tick_launches["columnar"][k] + kube_launches[k]
              for k in kube_launches}
    out = []
    for name, launches, path in (
        ("B1", mirror["B1"] + bench_launches["B1"] + modes_launches["B1"]
         + fleet_launches["B1"] + mesh_launches["B1"],
         "controller tick on the mirror, the bench, and the cand tiers"),
        ("B2", mirror["B2"] + bench_launches["B2"] + modes_launches["B2"]
         + fleet_launches["B2"] + mesh_launches["B2"],
         "controller tick on the mirror, the bench, and the cand tiers"),
        ("B3", stream_launches["B3"] + modes_launches["B3"]
         + fleet_launches["B3"] + mesh_launches["B3"],
         "streamed union, the bench's carry walls, and the carry tiers"),
        ("B4", stream_launches["B4"] + modes_launches["B4"]
         + fleet_launches["B4"] + mesh_launches["B4"],
         "streamed union, the bench's carry walls and parity smoke, and "
         "the carry tiers"),
        ("B5", mirror["B5"] + bench_launches["B5"] + modes_launches["B5"]
         + fleet_launches["B5"] + mesh_launches["B5"],
         "repair wherever a union's gate fires on the controller tick on "
         "the mirror, the bench, and the cand and 2-D tiers"),
    ):
        row = dict(timings[name])
        row.pop("what")
        row["launches"] = launches
        row["path"] = path
        row["launches_by_path"] = {
            "controller tick, mirror (phase 6)":
                tick_launches["columnar"][name],
            "controller tick, kube watch (phase 7)": kube_launches[name],
            "controller tick, objects (phase 6)":
                tick_launches["objects"][name],
            "planning tick (phase 3)": main_launches[name],
            "streamed union": stream_launches[name],
            "controller under the kube fault layer (phase 9)":
                chaos_launches[name],
            "bench (phase 10)": bench_launches.get(name, 0),
            "bench modes (phase 11)": modes_launches[name],
            "service-side bench modes (phase 12)": fleet_launches[name],
            "mesh tiers (phase 13)": mesh_launches[name],
        }
        out.append(row)
    for name in ("B1t", "B2t"):
        row = dict(service_rows[name])
        row["launches"] += fleet_launches[name] + mesh_launches[name]
        row["path"] = ("planner service batch (phase 8), the service-side "
                       "bench modes (phase 12), and the tenant mesh "
                       "(phase 13)")
        row["launches_by_path"] = {
            "planner service batch (phase 8)": service_launches[name],
            "planner service under the service fault layer (phase 8)":
                service_chaos_launches[name],
            "service-side bench modes (phase 12)": fleet_launches[name],
            "mesh tiers (phase 13)": mesh_launches[name]}
        out.append(row)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
