#!/usr/bin/env python3
"""Kernels B1-B4 timed at config 3 on one NVIDIA GPU.

    python3 k8s_spot_rescheduler_tpu_torch/ffd_timing.py [--tree DIR] [--experiments]

Imports ``k8s_spot_rescheduler_tpu_torch`` from DIR (by default the
checkout that holds this file), so that one run on the card can time two
versions of the kernels: an older commit unpacked under DIR, and this
one. On config 3 (the frozen ``data/config3_seed0.npz``), on all 2560
lanes and on the staged tick's 256-lane chunk (the chunk of the frozen
staged selection), it times B1 (``plan_ffd_kernel``), B2
(``best_fit=True``), and the carry-streamed union's two kernels at
n = 4 spot chunks: B3 (``plan_stream_ff_kernel``, first-fit over four
chunks of 640 spots) and B4 (``plan_stream_bf_kernel`` with the pack's
carry layout). Each two ways: one wrapper call (``ms``: median of 20
after warm-up, CUDA events around the call, host work included) and the
device time (``device_ms``: mean over 20 calls of the time
torch.profiler records in the kernels named in ``chip_smoke``'s
``FFD_KERNELS`` or ``STREAM_KERNELS``, every launch of a call summed,
null when it records none), with the timing helpers of this checkout's
``chip_smoke.py``.

With ``--experiments`` (needs this checkout's launch geometry) it also
gives B1/B2's device time with each lane's first k valid slots kept
(k = 0, 1, 8, all; k = 0 is the launch with its staging and outputs
alone) and across a sweep of launch geometries (lanes per block L, warps
per lane P, the statics in shared memory), each launch first checked
bit-identical to the default geometry's.

Prints the card's name and power limit as ``nvidia-smi`` gives them, one
line per measurement, and one JSON object of all of them last. Exits
non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_CHUNKS = 4  # the streamed union's spot chunks for B3 and B4
GEOMETRIES = (
    (False, [(L, 1) for L in (1, 4, 8, 16, 20, 32)]),
    (True, [(1, 1), (8, 1), (32, 1), (1, 2), (4, 2), (15, 2), (1, 4),
            (4, 4), (8, 4), (1, 8), (2, 8), (4, 8)]),
)


def slot_times(torch, smoke, fk, packed) -> dict:
    """{"B1 k=..": device ms} with each lane's first k valid slots kept
    (``smoke``: ``chip_smoke``, whose timing helpers these use)."""
    K = packed.slot_valid.shape[1]
    rank = packed.slot_valid.int().cumsum(1)  # the order of valid slots
    out = {}
    for k in (0, 1, 8, K):
        sub = packed._replace(slot_valid=packed.slot_valid & (rank <= k))
        for best_fit in (False, True):
            out[f"{'B2' if best_fit else 'B1'} k={k}"] = smoke.device_ms(
                torch, lambda: fk.launch_raw(sub, best_fit),
                smoke.FFD_KERNELS, reps=10)
    return out


def geometry_times(torch, smoke, fk, packed) -> dict:
    """{"B1 L=.. P=..": device ms} across ``GEOMETRIES``, each launch
    checked against the default geometry's answer."""
    C, K, S, R, W, A = fk.shapes(packed)
    out = {}
    for best_fit, pairs in GEOMETRIES:
        want = fk.launch_raw(packed, best_fit)
        for L, P in pairs:
            g = fk.fixed_geometry(K, S, R, W, A, L, P, True)
            got = fk.launch_raw(packed, best_fit, g)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise RuntimeError(
                    f"geometry L={L} P={P} best_fit={best_fit} changed "
                    f"the answer")
            out[f"{'B2' if best_fit else 'B1'} L={L} P={P}"] = smoke.device_ms(
                torch, lambda: fk.launch_raw(packed, best_fit, g),
                smoke.FFD_KERNELS, reps=10)
    return out


def load(tree: str) -> tuple:
    """(``chip_smoke`` of this checkout, for its timing helpers; then
    ``ops.ffd_kernels``, ``models.tensors`` and ``solver.carry`` of the
    port under ``tree``). chip_smoke is imported first, as ``tree``
    holds its own, older one."""
    import importlib

    sys.path.insert(0, HERE)
    smoke = importlib.import_module("chip_smoke")
    sys.path.insert(0, tree)
    port = "k8s_spot_rescheduler_tpu_torch"
    return smoke, *(importlib.import_module(f"{port}.{name}") for name in (
        "ops.ffd_kernels", "models.tensors", "solver.carry"))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--tree", default=HERE,
                        help="checkout whose port package is timed")
    parser.add_argument("--experiments", action="store_true",
                        help="also time slots kept and launch geometries")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ffd_timing: torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    tree = os.path.abspath(args.tree)
    smoke, fk, tensors, carry = load(tree)
    card = smoke.card_line()
    fk.build()
    host, ans = tensors.load_npz(os.path.join(
        tree, "k8s_spot_rescheduler_tpu_torch", "data", "config3_seed0.npz"))
    dev = tensors.to_device(host, "cuda")
    lo = int(ans["staged_selection"][0]) // 256 * 256
    chunk = dev._replace(**{
        f: getattr(dev, f)[lo:lo + 256]
        for f in ("slot_req", "slot_valid", "slot_tol", "slot_aff",
                  "cand_valid")
    })
    layout = carry.carry_layout(host)
    print(card, flush=True)
    result = {"tree": os.path.relpath(tree), "card": card, "chunk_at": lo,
              "kernels": {}}
    for where, packed in (("all lanes", dev), ("the 256-lane chunk", chunk)):
        calls = {
            "B1": (lambda: fk.plan_ffd_kernel(packed), smoke.FFD_KERNELS),
            "B2": (lambda: fk.plan_ffd_kernel(packed, best_fit=True),
                   smoke.FFD_KERNELS),
            "B3": (lambda: fk.plan_stream_ff_kernel(
                packed, carry_chunks=N_CHUNKS, layout=layout),
                smoke.FFD_KERNELS),
            "B4": (lambda: fk.plan_stream_bf_kernel(
                packed, carry_chunks=N_CHUNKS, layout=layout),
                smoke.STREAM_KERNELS),
        }
        for name, (call, kernels) in calls.items():
            row = {"ms": smoke.time_ms(torch, call),
                   "device_ms": smoke.device_ms(torch, call, kernels)}
            result["kernels"][f"{name} {where}"] = row
            print(f"{name} {where}: {row['ms']:.4f} ms a wrapper call, "
                  f"{smoke.fmt_ms(row['device_ms'])} ms on the device "
                  f"[{card}]",
                  flush=True)
    if args.experiments:
        for where, packed in (("all lanes", dev),
                              ("the 256-lane chunk", chunk)):
            for key, times in (
                ("slots kept", slot_times(torch, smoke, fk, packed)),
                ("geometry", geometry_times(torch, smoke, fk, packed)),
            ):
                result.setdefault(key, {})[where] = times
                print(f"{key}, {where}, device ms: " + ", ".join(
                    f"{k} {smoke.fmt_ms(v)}" for k, v in times.items()),
                    flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
