"""The port's constrained replay (``bench/replay.run_replay(...,
constrained=True)``) on the CPU against the JAX package's: config-5
churn with the full predicate surface. In a file of its own so that
``--dist loadfile`` gives the pair its own worker.

Tolerance: exact for every count field of the stats and for the
conservatism gauges. The event count is the fewest at which the JAX run
drains a node (1, seed 0).
"""

from __future__ import annotations

import torch

from k8s_spot_rescheduler_tpu.bench.replay import run_replay as ref_run_replay
from k8s_spot_rescheduler_tpu.utils.config import (
    ReschedulerConfig as RefConfig,
)
from k8s_spot_rescheduler_tpu_torch.bench.replay import run_replay
from k8s_spot_rescheduler_tpu_torch.metrics import registry as metrics
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig

torch.set_num_threads(1)

EVENTS = 1


def test_constrained_replay_equals_the_jax_package_and_never_strands():
    want = ref_run_replay(RefConfig(), n_events=EVENTS, seed=0,
                          constrained=True)
    got = run_replay(ReschedulerConfig(), n_events=EVENTS, seed=0,
                     constrained=True, device="cpu")
    assert set(got) == set(want)
    counts = [k for k in want if not k.startswith("replan_ms")]
    assert {k: got[k] for k in counts} == {k: want[k] for k in counts}
    assert want["drained_nodes"] > 0
    assert got["stranded_by_drain"] == 0
    snap = metrics.conservatism_snapshot()
    assert got["unplaceable_pods_gauge"] == snap["unplaceable_pods"]
    assert got["blocked_unmodeled_gauge"] == snap["blocked"].get(
        "unmodeled", 0.0)
