"""``python3 -m benchmark.control --workload <cell> --seconds <s> --seeds
<n> ...``: the control of a cell, on the card at the cell's size.

For each seed, in one process: a run of the program (its compared
numbers are the lower readings), then a run in which the plain
reference, with its taint guarantee broken (every pod admitted past every
taint), takes the program's place (its numbers are the upper readings). One JSON
line a run on standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import argparse

    from benchmark.__main__ import _environment

    p = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    _environment()
    from benchmark import harness

    cell = harness.Cell(harness.load_spec(), args.workload)
    for seed in args.seeds:
        for control in (False, True):
            res = harness.run(cell, seed, args.seconds, False, control=control)
            print(json.dumps({
                "workload": args.workload, "seed": seed, "control": control,
                "correct": res["correct"], "attempted": res["attempted"],
                "checks": {k: v["value"] for k, v in res["checks"].items()},
            }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
