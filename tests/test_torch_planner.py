"""The PyTorch port's planning tick on the CPU: the delta module against
the JAX package's columnar copy, the resident delta cache across ticks,
the staged plan and the schedule against the host oracles, and the
import boundary of the port (no jax, nothing of the JAX package).
"""

import ast
import os

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.bench.quality import pack_quality
from k8s_spot_rescheduler_tpu.io.synthetic import QUALITY_CONFIGS
from k8s_spot_rescheduler_tpu.models import columnar
from k8s_spot_rescheduler_tpu.solver.numpy_oracle import plan_union_oracle
from k8s_spot_rescheduler_tpu.solver.schedule import plan_schedule_oracle
from k8s_spot_rescheduler_tpu_torch.models import delta as tdelta
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    to_device,
)
from k8s_spot_rescheduler_tpu_torch.planner.solver_planner import (
    TorchSolverPlanner,
)
from k8s_spot_rescheduler_tpu_torch.solver.schedule import commit_step_host
from k8s_spot_rescheduler_tpu_torch.utils.config import ReschedulerConfig
from tests.test_solver import _random_packed

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "k8s_spot_rescheduler_tpu_torch")
QUALITY_SPEC = next(iter(QUALITY_CONFIGS.values()))


def _churn(packed, rng):
    """A next-tick pack: a few lanes, validity bits and spot rows
    changed, shapes kept."""
    C, K, _ = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    new = {f: np.array(getattr(packed, f)) for f in packed._fields}
    for c in rng.choice(C, size=min(2, C), replace=False):
        new["slot_req"][c] = rng.integers(0, 900, new["slot_req"][c].shape)
        new["slot_valid"][c] = rng.random(K) < 0.7
        new["slot_aff"][c] ^= np.uint32(1 << 31)
    new["cand_valid"][rng.integers(0, C)] ^= True
    for s in rng.choice(S, size=min(3, S), replace=False):
        new["spot_free"][s] -= 50
        new["spot_count"][s] += 1
        new["spot_taints"][s] ^= np.uint32(2)
        new["spot_ok"][s] ^= True
        new["spot_aff"][s] |= np.uint32(1 << 30)
    return PackedCluster(**new)


def _selection(sel):
    return np.concatenate([[sel.index, int(sel.found), sel.n_feasible], sel.row])


def _oracle_selection(packed):
    res = plan_union_oracle(packed, repair_rounds=8)
    feasible = np.asarray(res.feasible)
    idx = int(np.argmax(feasible))
    return np.concatenate(
        [
            [idx, int(feasible.any()), int(feasible.sum())],
            np.asarray(res.assignment[idx], np.int32),
        ]
    )


# --- models/delta -----------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_delta_matches_columnar(seed):
    rng = np.random.default_rng(700 + seed)
    prev = _random_packed(rng)
    new = _churn(prev, rng)
    want = columnar.emit_packed_delta(prev, new)
    got = tdelta.emit_packed_delta(prev, new)
    C = prev.slot_req.shape[0]
    S = prev.spot_free.shape[0]
    for w, g in (
        (want, got),
        (columnar.pad_packed_delta(want, C, S),
         tdelta.pad_packed_delta(got, C, S)),
    ):
        for f in w._fields:
            np.testing.assert_array_equal(getattr(w, f), getattr(g, f))
            assert getattr(w, f).dtype == getattr(g, f).dtype
    assert got.n_lanes == want.n_lanes and got.nbytes == want.nbytes
    assert tdelta.emit_packed_delta(prev, prev._replace(
        spot_ok=prev.spot_ok[:-1])) is None


@pytest.mark.parametrize("n", [0, 1, 8, 9, 100, 1024, 1025])
def test_pad_pow2_matches_columnar(n):
    assert tdelta.pad_pow2(n) == columnar.pad_pow2(n)


# --- the resident delta cache -------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_delta_cache_across_two_ticks(seed):
    rng = np.random.default_rng(800 + seed)
    tick1 = _random_packed(rng)
    tick2 = _churn(tick1, rng)
    planner = TorchSolverPlanner(device="cpu")
    sel1 = planner.plan_packed(tick1)
    assert planner.last_upload[1]  # first tick: full upload
    sel2 = planner.plan_packed(tick2)
    lanes, full, sent = planner.last_upload
    assert not full and lanes >= 0 and sent > 0
    # the resident tensors now hold exactly a fresh upload of tick 2
    fresh = to_device(tick2, "cpu")
    for f in PackedCluster._fields:
        assert torch.equal(getattr(planner._device_packed, f), getattr(fresh, f)), f
    np.testing.assert_array_equal(
        _selection(sel2),
        _selection(TorchSolverPlanner(device="cpu").plan_packed(tick2)),
    )
    want1 = _oracle_selection(tick1)  # early exit: compare all but the count
    assert (sel1.index, int(sel1.found)) == (want1[0], want1[1])
    np.testing.assert_array_equal(sel1.row, want1[3:])
    assert planner.fetches_total == 2


def test_shape_growth_reuploads_in_full():
    tick1 = _random_packed(np.random.default_rng(9))
    S = tick1.spot_free.shape[0]
    grown = tick1._replace(
        **{
            f: np.concatenate([getattr(tick1, f), getattr(tick1, f)[:1]])
            for f in PackedCluster._fields
            if f.startswith("spot_")
        }
    )
    planner = TorchSolverPlanner(device="cpu")
    planner.plan_packed(tick1)
    planner.plan_packed(grown)
    assert planner.last_upload[:2] == (-1, True)
    assert planner._device_packed.spot_free.shape[0] == S + 1


def _assert_resident_is(planner, packed):
    fresh = to_device(packed, "cpu")
    for f in PackedCluster._fields:
        assert torch.equal(getattr(planner._device_packed, f),
                           getattr(fresh, f)), f


@pytest.mark.parametrize("seed", range(3))
def test_failed_delta_apply_uploads_in_full(seed, monkeypatch):
    """A copy that raises part way through a delta (after the lane
    fields, at ``spot_free``) leaves the resident tensors half written:
    that tick uploads in full, equal to a fresh upload, and the next
    tick diffs against it correctly."""
    rng = np.random.default_rng(900 + seed)
    tick1 = _random_packed(rng)
    tick2 = _churn(tick1, rng)
    tick3 = _churn(tick2, rng)
    planner = TorchSolverPlanner(device="cpu")
    planner.plan_packed(tick1)
    target = planner._device_packed.spot_free.data_ptr()
    copy = torch.Tensor.index_copy_
    failed = []

    def failing_copy(self, dim, index, source):
        if self.data_ptr() == target:
            failed.append(True)
            raise RuntimeError("injected copy failure")
        return copy(self, dim, index, source)

    monkeypatch.setattr(torch.Tensor, "index_copy_", failing_copy)
    sel2 = planner.plan_packed(tick2)
    monkeypatch.undo()
    assert failed and planner.last_upload[:2] == (-1, True)
    _assert_resident_is(planner, tick2)
    np.testing.assert_array_equal(
        _selection(sel2),
        _selection(TorchSolverPlanner(device="cpu").plan_packed(tick2)),
    )
    sel3 = planner.plan_packed(tick3)
    lanes, full, _ = planner.last_upload
    assert not full and lanes >= 0
    _assert_resident_is(planner, tick3)
    np.testing.assert_array_equal(
        _selection(sel3),
        _selection(TorchSolverPlanner(device="cpu").plan_packed(tick3)),
    )


def test_failed_delta_then_failed_upload_leaves_no_stale_cache(monkeypatch):
    """When the full upload after a failed delta fails too, the tick
    raises; the cache it leaves is empty, not half written, so the next
    tick uploads in full and holds exactly its own pack."""
    from k8s_spot_rescheduler_tpu_torch.planner import solver_planner

    rng = np.random.default_rng(950)
    tick1 = _random_packed(rng)
    tick2 = _churn(tick1, rng)
    tick3 = _churn(tick2, rng)
    planner = TorchSolverPlanner(device="cpu")
    planner.plan_packed(tick1)
    target = planner._device_packed.spot_free.data_ptr()
    copy = torch.Tensor.index_copy_

    def failing_copy(self, dim, index, source):
        if self.data_ptr() == target:
            raise RuntimeError("injected copy failure")
        return copy(self, dim, index, source)

    def failing_upload(packed, device=None):
        raise RuntimeError("injected upload failure")

    monkeypatch.setattr(torch.Tensor, "index_copy_", failing_copy)
    monkeypatch.setattr(solver_planner, "to_device", failing_upload)
    with pytest.raises(RuntimeError, match="upload failure"):
        planner.plan_packed(tick2)
    monkeypatch.undo()
    assert planner._device_packed is None and planner._host_prev is None
    sel3 = planner.plan_packed(tick3)
    assert planner.last_upload[:2] == (-1, True)
    _assert_resident_is(planner, tick3)
    np.testing.assert_array_equal(
        _selection(sel3),
        _selection(TorchSolverPlanner(device="cpu").plan_packed(tick3)),
    )


# --- the tick against the host oracles ----------------------------------------


@pytest.mark.parametrize("staged_chunk_lanes", [0, 3])
def test_plan_packed_matches_the_oracle_union(staged_chunk_lanes):
    packed = pack_quality(QUALITY_SPEC, 2)
    cfg = ReschedulerConfig(
        staged_chunk_lanes=staged_chunk_lanes, staged_early_exit=False
    )
    sel = TorchSolverPlanner(cfg, device="cpu").plan_packed(packed)
    np.testing.assert_array_equal(_selection(sel), _oracle_selection(packed))


def test_plan_schedule_then_delta_tick():
    """The chip smoke's tick at a small size: schedule == the oracle's,
    then the first drain committed and planned through the delta cache
    equals the schedule's second step."""
    packed = pack_quality(QUALITY_SPEC, 0)
    planner = TorchSolverPlanner(
        ReschedulerConfig(schedule_horizon=6), device="cpu"
    )
    steps, mat = planner.plan_schedule_packed(packed)
    np.testing.assert_array_equal(
        mat, plan_schedule_oracle(packed, 6, repair_rounds=8)
    )
    assert len(steps) >= 2
    tick2 = commit_step_host(packed, steps[0].index, steps[0].row)
    sel = planner.plan_packed(tick2)
    assert not planner.last_upload[1]
    assert sel.found and sel.index == steps[1].index
    np.testing.assert_array_equal(sel.row, steps[1].row)
    assert planner.fetches_total == 2


# --- the import boundary ------------------------------------------------------


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


@pytest.mark.parametrize(
    "path", _port_files(), ids=lambda p: os.path.relpath(p, REPO)
)
def test_port_imports_neither_jax_nor_the_jax_package(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top != "jax" and top != "jaxlib", (path, name)
        assert top != "k8s_spot_rescheduler_tpu", (path, name)
