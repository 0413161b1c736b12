"""``python3 -m benchmark --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``, on one card.

Prints progress and the numbers the check compared (each beside its
limit, last) on standard error, and the result as one JSON object, the
last line of standard output. Without a card, or with fewer cards than
the cell asks for, it exits 1 and prints no result.
"""

from __future__ import annotations

import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _environment() -> None:
    """One process with few threads; the program's build and kernel
    caches at fixed paths inside the checkout."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(
        CHECKOUT, "build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CHECKOUT, "build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="python3 -m benchmark")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    _environment()
    from benchmark import harness

    t_start = harness.process_start_epoch()
    if CHECKOUT not in sys.path:
        sys.path.insert(0, CHECKOUT)
    try:
        cell = harness.Cell(harness.load_spec(), args.workload)
        result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                             t_start=t_start)
    except harness.BenchError as err:
        print(f"benchmark: {err}", file=sys.stderr)
        return 1
    import json

    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
