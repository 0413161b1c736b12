"""The comparison that decides ``correct``.

The plain reference (``plain.py``) works each checked cut out again from
the same generated cluster, replayed from the seed to the call, and
shares no code with the program. The program's answer is taken by name
at the call (``Answer.of``), so the two sides meet only in node and pod
names. Compared, summed over the calls sampled from the window
(``Check``):

- ``orders_off``: positions where the program's candidate order or spot
  probe order differs from the reference's (the pack it solved), and the
  difference of their lengths;
- ``steps_off``: steps of the cut whose drained node or feasible count
  differ, and the difference of the cuts' lengths;
- ``placements_off``: pods whose target spot node differs, a pod on one
  side only counted once.

Each has the limit 0: the answers are exact.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from benchmark import plain

NUMBERS = ("orders_off", "steps_off", "placements_off")
LIMITS = {name: 0 for name in NUMBERS}


class Answer:
    """A cut by name: the candidate and spot orders it was solved over
    and its steps (``plain.Step``)."""

    def __init__(self, call: int, cand: List[str], spot: List[str],
                 steps: List[plain.Step]):
        self.call = call
        self.cand = cand
        self.spot = spot
        self.steps = steps

    @classmethod
    def of(cls, call: int, schedule) -> "Answer":
        """The program's cut (``planner/schedule.DrainSchedule``), named
        through the meta it was solved with (its ``_base_meta``; the
        schedule keeps it for its own per-step checks) while the mirror
        is as the cut saw it. An index out of range names nothing."""
        meta = schedule._base_meta
        store = meta.store
        cand = [store.node_objs[int(r)].name for r in meta.cand_rows]
        spot = [store.node_objs[int(r)].name for r in meta.spot_rows]

        def name(names, i):
            return names[i] if 0 <= i < len(names) else None

        steps = []
        for s in schedule.steps:
            c = int(s.index)
            pods = meta.candidate_pods(c) if 0 <= c < len(cand) else []
            steps.append(plain.Step(
                name(cand, c), int(s.n_feasible),
                {p.uid: name(spot, int(s.row[k])) for k, p in enumerate(pods)}))
        return cls(call, cand, spot, steps)


def _positions_off(a: List[str], b: List[str]) -> int:
    return sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))


def compare(prog: Answer, ref: Answer) -> Dict[str, int]:
    """The three numbers of one call: see the module's docstring."""
    steps_off = abs(len(prog.steps) - len(ref.steps))
    placements_off = 0
    for i in range(max(len(prog.steps), len(ref.steps))):
        a = prog.steps[i].targets if i < len(prog.steps) else {}
        b = ref.steps[i].targets if i < len(ref.steps) else {}
        placements_off += sum(a.get(u) != b.get(u) for u in set(a) | set(b))
        if i < len(prog.steps) and i < len(ref.steps):
            pa, rb = prog.steps[i], ref.steps[i]
            steps_off += int(pa.node != rb.node or pa.n_feasible != rb.n_feasible)
    return {
        "orders_off": (_positions_off(prog.cand, ref.cand)
                       + _positions_off(prog.spot, ref.spot)),
        "steps_off": steps_off,
        "placements_off": placements_off,
    }


class Check:
    """The sample of calls to check, drawn from the seed by a reservoir
    over the window's calls (``offer`` at each call, before the next
    churn; ``keep`` records the kept call's answer), and the check
    itself (``run``) once the window has closed."""

    def __init__(self, seed: int, size: int):
        self.rng = np.random.default_rng([int(seed), 2])
        self.size = size
        self.seen = 0
        self.kept: Dict[int, Answer] = {}
        self._slots: List[int] = []

    def offer(self, call: int) -> Optional[int]:
        """The slot call ``call`` takes, or None when it is not kept."""
        self.seen += 1
        if len(self._slots) < self.size:
            self._slots.append(call)
            return len(self._slots) - 1
        j = int(self.rng.integers(0, self.seen))
        if j < self.size:
            self.kept.pop(self._slots[j], None)
            self._slots[j] = call
            return j
        return None

    def keep(self, answer: Answer) -> None:
        self.kept[answer.call] = answer

    def run(self, dep: dict, ctl: dict, device, replay, *,
            control: bool = False) -> Dict[str, int]:
        """Replay the churn to each kept call (``replay(calls)`` yields,
        for each of ``calls`` in order, the call and the cluster after
        the churn of calls 0 to it), cut it with the reference and
        compare. ``control`` puts the reference with its taint guarantee
        broken in the program's place."""
        totals = {name: 0 for name in NUMBERS}
        totals["calls_checked"] = 0
        for call, cluster in replay(sorted(self.kept)):
            prog = self.kept[call]
            P, steps = plain.solve_cut(cluster, dep, ctl, device)
            ref = Answer(call, P.cand_names, P.spot_names, steps)
            if control:
                B, bad = plain.solve_cut(cluster, dep, ctl, device,
                                         drop_taints=True)
                prog = Answer(call, B.cand_names, B.spot_names, bad)
            for name, value in compare(prog, ref).items():
                totals[name] += value
            totals["calls_checked"] += 1
        return totals
