"""The frozen full-size problems the chip smoke runs (``k8s_spot_
rescheduler_tpu_torch/data/``) against the JAX package on the CPU: each
pack equals a fresh pack of its synthetic config, and its stored
selection equals the JAX fused union's; on the contended problem the
port's union and repair equal the stored lane-level JAX answers.
``tests/torch_port_fixtures.py`` writes them; a change to the pack path
or the solver that moves either turns this red until they are re-frozen.
"""

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.models.tensors import PackedCluster
from k8s_spot_rescheduler_tpu.solver.fallback import with_repair
from k8s_spot_rescheduler_tpu.solver.ffd import plan_ffd
from k8s_spot_rescheduler_tpu.solver.select import make_fused_planner
from k8s_spot_rescheduler_tpu_torch.models.tensors import load_npz, to_device
from k8s_spot_rescheduler_tpu_torch.solver import fallback as tfallback
from k8s_spot_rescheduler_tpu_torch.solver import ffd as tffd
from k8s_spot_rescheduler_tpu_torch.solver import repair as trepair
from tests.torch_port_fixtures import (
    CONTENDED,
    HORIZON,
    frozen_path,
    pack_config,
)

torch.set_num_threads(1)


@pytest.mark.parametrize("config_id", [3, 4, CONTENDED])
def test_frozen_pack_and_selection_match_the_jax_package(config_id):
    frozen, answers = load_npz(frozen_path(config_id))
    assert str(answers["config_id"]) == str(config_id)
    fresh = pack_config(config_id, int(answers["seed"]))
    for f in PackedCluster._fields:
        want = getattr(fresh, f)
        got = getattr(frozen, f)
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)
    selection = np.asarray(
        make_fused_planner(with_repair(plan_ffd, 8))(PackedCluster(*frozen))
    )
    np.testing.assert_array_equal(answers["selection"], selection)
    K = frozen.slot_req.shape[1]
    assert answers["schedule"].shape == (HORIZON, 3 + K)
    assert answers["staged_selection"].shape == (3 + K,)
    # the staged selection agrees with the unstaged one but its count
    np.testing.assert_array_equal(
        answers["staged_selection"][[0, 1]], selection[[0, 1]]
    )
    np.testing.assert_array_equal(
        answers["staged_selection"][3:], selection[3:]
    )


@pytest.mark.parametrize("solver", ["union", "repair"])
def test_port_matches_the_frozen_contended_lane_answers(solver):
    """Repair runs here: greedy leaves most valid lanes unproven."""
    frozen, answers = load_npz(frozen_path(CONTENDED))
    packed = to_device(frozen, "cpu")
    if solver == "union":
        got = tfallback.with_repair(tffd.plan_ffd, 8)(packed)
        greedy = tfallback.with_best_fit_fallback(tffd.plan_ffd)(packed)
        assert int(greedy.feasible.sum()) < int(got.feasible.sum())
    else:
        got = trepair.plan_repair(packed, rounds=8)
    np.testing.assert_array_equal(
        got.feasible.numpy(), answers[f"{solver}_feasible"]
    )
    np.testing.assert_array_equal(
        got.assignment.numpy(), answers[f"{solver}_assignment"]
    )
