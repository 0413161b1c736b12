"""The port's ``--carry-wall`` (``k8s_spot_rescheduler_tpu_torch/bench/
carry_wall.py``) on the CPU, held against the root ``bench.py``'s
``run_carry_wall`` on the JAX package, on config 3 at scale 0.02
(C=56, S=56).

Tolerance: exact. With ``--carry-chunks 4`` and with the ladder's count
(8 at this scale) the row's chunk count, carry plane bytes, feasible and
valid lanes and bucket key equal the reference's, and the streamed
union's feasible mask and assignment equal the JAX package's
``with_repair_streamed`` on the same pack, bit for bit.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu.io.synthetic import CONFIGS as REF_CONFIGS
from k8s_spot_rescheduler_tpu.solver.carry import (
    carry_layout as ref_carry_layout,
)
from k8s_spot_rescheduler_tpu.solver.fallback import (
    with_repair_streamed as ref_with_repair_streamed,
)
from k8s_spot_rescheduler_tpu_torch import testing
from k8s_spot_rescheduler_tpu_torch.bench import __main__ as bench_main
from k8s_spot_rescheduler_tpu_torch.bench import carry_wall
from k8s_spot_rescheduler_tpu_torch.io.synthetic import CONFIGS
from k8s_spot_rescheduler_tpu_torch.models.tensors import to_device
from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    CarryLayout,
    carry_layout,
)
from k8s_spot_rescheduler_tpu_torch.solver.fallback import with_repair_streamed
from tests.torch_port_fixtures import (
    CARRY_KEYS,
    pack_spec,
    reference_carry_wall,
)

torch.set_num_threads(1)

CONFIG, SCALE = 3, 0.02


def _port_row(chunks: int) -> dict:
    rc, row = bench_main.run(["--device", "cpu", "--carry-wall", "--config",
                          str(CONFIG), "--scale", str(SCALE),
                          "--carry-chunks", str(chunks), "--repeats", "1"])
    assert rc == 0
    return row


@pytest.mark.parametrize("chunks", (4, 0), ids=("pinned-4", "ladder"))
def test_carry_wall_row_equals_the_jax_package(chunks):
    want = reference_carry_wall(CONFIG, SCALE, chunks, 0)
    row = _port_row(chunks)
    assert {k: row[k] for k in CARRY_KEYS} == {k: want[k] for k in CARRY_KEYS}
    assert row["bucket"] == want["bucket"]
    assert list(row["twin_calibration"]) == [want["bucket"]]
    assert row["metric"] == "carry_union_wall_ms_config3_x0.02"
    assert row["backend_attestation"]["solve_backend"] == "cpu"
    assert row["launches"]["B3"] == row["launches"]["B4"] == 0
    if chunks == 0:
        assert row["carry_chunks"] == 8


def test_streamed_union_lanes_equal_the_jax_package():
    spec = bench_main.scaled_spec(CONFIGS[CONFIG], SCALE)
    packed = bench_main.build_problem(spec, 0)[0]
    ref_packed = pack_spec(bench_main.scaled_spec(REF_CONFIGS[CONFIG], SCALE), 0)
    for f in packed._fields:
        assert np.array_equal(np.asarray(getattr(packed, f)),
                              np.asarray(getattr(ref_packed, f))), f
    layout = carry_layout(packed)
    assert tuple(layout) == tuple(ref_carry_layout(ref_packed))
    want = jax.jit(ref_with_repair_streamed(8, 4, ref_carry_layout(
        ref_packed)))(ref_packed)
    got = with_repair_streamed(8, 4, layout, use_kernel=True)(
        to_device(packed, "cpu"))
    assert np.array_equal(got.feasible.numpy(), np.asarray(want.feasible))
    assert np.array_equal(got.assignment.numpy(),
                          np.asarray(want.assignment))


def test_ladder_chunks_at_the_frozen_config():
    """The 20x verdict at config 3 is the frozen row's count, from the
    shapes alone (no solve)."""
    frozen = testing.load_bench()["carry"]
    shapes = (2560, 32, 2560, 4, 1, 2)  # config 3's pack at seed 0
    layout = CarryLayout(used="int16", count="int8", aff="uint8")
    assert carry_wall.ladder_chunks(shapes, layout, 1.0) == frozen["ladder"][
        "carry_chunks"]
    assert frozen["pinned"]["carry_chunks"] == testing.BENCH_CARRY_CHUNKS
