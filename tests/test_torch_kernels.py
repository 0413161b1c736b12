"""Kernels B1-B4 against their plain PyTorch versions.

This file imports torch, numpy and the port only, never jax, so it also
runs on a machine with a card and no jax (skipping the jax-importing
``conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Without a card the ``cuda``-marked tests skip and the rest check the
wrappers' CPU path: the plain version, and no launch.
"""

import os
import re

import numpy as np
import pytest
import torch

from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    to_device,
)
from k8s_spot_rescheduler_tpu_torch.ops import ffd_kernels
from k8s_spot_rescheduler_tpu_torch.solver.carry import (
    CarryLayout,
    carry_layout,
)
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    ffd_raw,
    plan_ffd,
    plan_ffd_streamed,
)
from k8s_spot_rescheduler_tpu_torch.testing import (
    PAST_SMEM_SHAPE,
    STRESS_LAYOUTS,
    past_smem_pack,
    overlay_stress_packs,
    random_bits,
    random_pack,
)

torch.set_num_threads(1)


def _host_pack(seed: int, S: int = 0, R: int = 0) -> PackedCluster:
    """A seeded random host pack of random shape (``random_pack``)."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 24))
    K = int(rng.integers(1, 9))
    S = S or int(rng.integers(1, 300))
    R = R or int(rng.integers(1, 5))
    return random_pack(rng, C, K, S, R)


def _layout_pack(
    seed: int, layout: CarryLayout, S: int = 0, R: int = 2
) -> PackedCluster:
    """A seeded random pack whose ``carry_layout`` is exactly ``layout``:
    lane 0's first slot carries a request past 32,767 (uint16) or 65,535
    (float32) with a spot that takes it, K is 130 for int16 counts, and
    the affinity bits reach bit 8 (uint16) or bit 31 (uint32)."""
    rng = np.random.default_rng(seed)
    K = 130 if layout.count == "int16" else int(rng.integers(2, 12))
    base = _host_pack(seed, S=S or int(rng.integers(40, 300)), R=R)
    C = base.slot_req.shape[0]
    S = base.spot_free.shape[0]
    W, A = 1, 2
    top = {"uint8": 8, "uint16": 16, "uint32": 32}[layout.aff]
    slot_aff = random_bits(rng, (C, K, A), top=top)
    slot_aff[0, 0, 0] = np.uint32(1) << (top - 1)
    # K * the largest request stays inside int16
    slot_req = rng.integers(0, 24 if K > 12 else 60, (C, K, R)).astype(
        np.float32
    ) * 10
    slot_req[0, 0, 0] = {"int16": 100.0, "uint16": 40000.0,
                         "float32": 70000.0}[layout.used]
    slot_valid = rng.random((C, K)) < 0.8
    slot_valid[0, 0] = True
    spot_free = base.spot_free.copy()
    spot_free[S // 2] = 80000.0  # a spot that takes the large request
    packed = base._replace(
        slot_req=slot_req,
        slot_valid=slot_valid,
        slot_tol=rng.integers(0, 4, (C, K, W)).astype(np.uint32),
        slot_aff=slot_aff,
        spot_free=spot_free,
        spot_max_pods=rng.integers(1, 40 if K > 12 else 8, (S,)).astype(
            np.int32
        ),
    )
    assert carry_layout(packed) == layout
    return packed


LAYOUTS = [
    CarryLayout(used, count, aff)
    for used in ("int16", "uint16", "float32")
    for count in ("int8", "int16")
    for aff in ("uint8", "uint16", "uint32")
]


def _assert_same(a, b):
    assert torch.equal(a.feasible, b.feasible)
    assert torch.equal(a.assignment, b.assignment)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


# --- the CPU path -------------------------------------------------------------


@pytest.mark.parametrize("seed", range(6))
def test_wrappers_take_the_plain_version_on_cpu_tensors(seed):
    packed = to_device(_host_pack(seed), "cpu")
    before = dict(ffd_kernels.LAUNCHES)
    for best_fit in (False, True):
        _assert_same(
            ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit),
            plan_ffd(packed, best_fit=best_fit),
        )
    _assert_same(ffd_kernels.plan_ffd_chunked(packed, 7), plan_ffd(packed))
    assert ffd_kernels.LAUNCHES == before


def test_raw_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ffd_kernels.launch_raw(to_device(_host_pack(0), "cpu"), False)


def _c_params(source: str, function: str):
    """(name, type) of each parameter of the C function ``function`` in
    ``source``, in order; the type without ``const`` or spaces."""
    m = re.search(rf"\bint {function}\((.*?)\)\s*{{", source, re.S)
    assert m, f"{function} not found"
    params = []
    for decl in m.group(1).split(","):
        decl = re.sub(r"\bconst\b", "", decl)
        name = re.findall(r"\w+", decl)[-1]
        ctype = decl.replace(name, "").replace(" ", "").replace("\n", "")
        params.append((name, ctype))
    return params


@pytest.mark.parametrize(
    "source, function, args",
    [
        ("ffd", "ffd_launch", ffd_kernels.LAUNCH_ARGS),
        ("stream_bf", "stream_bf_launch", ffd_kernels.STREAM_LAUNCH_ARGS),
    ],
    ids=["ffd_launch", "stream_bf_launch"],
)
def test_launch_args_match_the_c_signature(source, function, args):
    """Each ctypes call is built from its LAUNCH_ARGS; no compiler checks
    it against the source, so this does: names, order, pointer or int,
    and the element type behind each pointer."""
    with open(ffd_kernels.SOURCES[source]) as f:
        params = _c_params(f.read(), function)
    c_types = {
        "float*": torch.float32,
        "uint8_t*": torch.bool,
        "int32_t*": torch.int32,
        "int": "int",
        "void*": "stream",
    }
    assert [(name, c_types[ctype]) for name, ctype in params] == list(args)


def test_build_hashes_every_source(tmp_path, monkeypatch):
    """Each source has its own library, named by the hash of that
    source and of the headers the sources include: editing one source
    renames its library alone, editing a header renames every library,
    so the next build compiles what changed."""
    sources = {}
    for name in ffd_kernels.SOURCES:
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    header = tmp_path / "greedy.cuh"
    header.write_text("// header\n")
    monkeypatch.setattr(ffd_kernels, "SOURCES", {
        name: str(path) for name, path in sources.items()
    })
    monkeypatch.setattr(ffd_kernels, "HEADERS", (str(header),))
    before = {name: ffd_kernels._library_path(name) for name in sources}
    sources["stream_bf"].write_text("// stream_bf, edited\n")
    after = {name: ffd_kernels._library_path(name) for name in sources}
    assert after["ffd"] == before["ffd"]
    assert after["stream_bf"] != before["stream_bf"]
    assert len(set(after.values())) == len(sources)
    header.write_text("// header, edited\n")
    again = {name: ffd_kernels._library_path(name) for name in sources}
    assert all(again[name] != after[name] for name in sources)


def test_every_source_includes_only_the_hashed_headers():
    """A header the sources include but the build does not hash would
    load a stale library after an edit."""
    hashed = {os.path.basename(path) for path in ffd_kernels.HEADERS}
    for path in ffd_kernels.SOURCES.values():
        with open(path) as f:
            included = set(re.findall(r'#include "([^"]+)"', f.read()))
        assert included and included <= hashed
    for path in ffd_kernels.HEADERS:
        assert os.path.dirname(path) == ffd_kernels.CSRC


# (C, K, S, R, W, A) of the geometry cases: config 3, contended, S=9000
# at R=4, K=130, S=1, and a K whose one lane exceeds shared memory
GEOMETRY_SHAPES = {
    "config3": (2560, 32, 2560, 4, 1, 2),
    "contended": (512, 8, 1152, 2, 17, 2),
    "s9000": (300, 32, 9000, 4, 1, 2),
    "k130": (24, 130, 200, 4, 1, 2),
    "s1": (7, 5, 1, 1, 1, 2),
    "impossible_k": (8, 5000, 2560, 4, 1, 2),
}


@pytest.mark.parametrize("best_fit", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("case", GEOMETRY_SHAPES, ids=str)
def test_launch_geometry(case, best_fit):
    """The launch shape at an H100's limits: threads and shared memory
    within the card's, one warp per lane for first-fit, the statics
    staged where they fit and read from device memory past that, and the
    lanes in the device-memory workspace where one lane's state alone is
    too large for shared memory (``impossible_k``)."""
    C, K, S, R, W, A = GEOMETRY_SHAPES[case]
    limit = ffd_kernels.H100_SMEM_LIMIT
    g = ffd_kernels.launch_geometry(C, K, S, R, W, A, limit, best_fit)
    L, P = g.lanes_per_block, g.warps_per_lane
    assert 1 <= L and g.threads == 32 * L * P <= 1024
    assert g.smem_bytes <= limit
    assert g.lane_bytes == 4 * (K * (2 * R + W + 2 * A + 3) + -(-S // 32) + 4 * P)
    assert g.statics_bytes == 4 * S * (R + 1 + W + A)
    staged = g.statics_bytes if g.statics_in_smem else 0
    assert g.lanes_in_smem == (case != "impossible_k")
    assert g.lanes_in_smem == (g.lane_bytes <= limit)
    assert g.smem_bytes == staged + (L * g.lane_bytes if g.lanes_in_smem else 0)
    # lanes spread over the SMs, unless a block would stage the statics
    # with fewer warps than STAGING_WARPS
    assert L <= min(C, max(-(-C // ffd_kernels.H100_SMS),
                           ffd_kernels.STAGING_WARPS // P))
    assert L * P >= min(ffd_kernels.STAGING_WARPS, C * P)
    if best_fit:
        assert P in (1, 2, 4, 8) and P <= max(1, -(-S // 32))
        assert P == 1 or L <= ffd_kernels.MAX_NAMED_LANES
    else:
        assert P == 1
    assert g.statics_in_smem == (case != "s9000")
    if case == "config3":
        assert L >= 4
    if case == "s1":
        assert (L, P) == (C, 1)


def test_launch_geometry_grows_lanes_until_shared_memory_binds():
    """With few SMs to spread over, lanes per block grow until threads
    or shared memory stop them, and the statics keep their place."""
    limit = ffd_kernels.H100_SMEM_LIMIT
    g = ffd_kernels.launch_geometry(2560, 32, 2560, 4, 1, 2, limit, False,
                                    n_sm=1)
    assert g.lanes_per_block == 32  # 1,024 threads bind first
    g = ffd_kernels.launch_geometry(2560, 500, 2560, 4, 1, 2, limit, False,
                                    n_sm=1)
    assert g.statics_in_smem
    assert g.smem_bytes + g.lane_bytes > limit >= g.smem_bytes  # smem binds


# (C, K, S, R, W, A, layout, SMs) of B4's geometry cases: configs 3
# and 4, contended, the wide layout, S=24000 past shared memory, K=130
# (int16 counts), a float32 `used`, and one SM with two warps a lane,
# where the 15 named barriers cap the lanes
STREAM_GEOMETRY_SHAPES = {
    "config3": (2560, 32, 2560, 4, 1, 2, CarryLayout("int16", "int8", "uint8"),
                132),
    "config4": (2560, 32, 2560, 4, 1, 2,
                CarryLayout("int16", "int8", "uint32"), 132),
    "contended": (512, 8, 1152, 2, 17, 2,
                  CarryLayout("int16", "int8", "uint32"), 132),
    "wide": (2560, 32, 2560, 4, 1, 2, CarryLayout(), 132),
    "s24000": (64, 32, 24000, 4, 1, 2, CarryLayout("int16", "int8", "uint8"),
               132),
    "k130": (24, 130, 200, 4, 1, 2, CarryLayout("int16", "int16", "uint32"),
             132),
    "float_used": (300, 12, 700, 3, 1, 2,
                   CarryLayout("float32", "int8", "uint16"), 132),
    "cap15": (2560, 8, 64, 2, 1, 2, CarryLayout("int16", "int8", "uint8"), 1),
}
_ITEMSIZE = {"int8": 1, "uint8": 1, "int16": 2, "uint16": 2, "int32": 4,
             "uint32": 4, "float32": 4}


@pytest.mark.parametrize("case", STREAM_GEOMETRY_SHAPES, ids=str)
def test_stream_geometry(case):
    """B4's launch shape: B2's warps and lanes, a lane's bytes counted
    as stream_bf.cu counts them (slot rows, K overlay entries in the
    layout's dtypes with each plane padded to a word, the touched bitmap,
    the partials), never a plane over every spot, and the statics in
    shared memory where they fit and in device memory past that."""
    C, K, S, R, W, A, lay, n_sm = STREAM_GEOMETRY_SHAPES[case]
    limit = ffd_kernels.H100_SMEM_LIMIT
    g = ffd_kernels.launch_geometry(C, K, S, R, W, A, limit, True, n_sm=n_sm,
                                    layout=lay)
    b2 = ffd_kernels.launch_geometry(C, K, S, R, W, A, limit, True, n_sm=n_sm)
    L, P = g.lanes_per_block, g.warps_per_lane
    assert P == b2.warps_per_lane and g.threads == 32 * L * P <= 1024
    entries = (-(-R * K * _ITEMSIZE[lay.used] // 4)
               + -(-K * _ITEMSIZE[lay.count] // 4)
               + -(-A * K * _ITEMSIZE[lay.aff] // 4))
    assert g.lane_bytes == 4 * (K * (R + W + A + 2) + entries + -(-S // 32)
                                + 4 * P)
    assert g.lane_bytes <= b2.lane_bytes
    assert (g.lane_bytes < b2.lane_bytes) == (lay != CarryLayout())
    assert g.statics_bytes == b2.statics_bytes == 4 * S * (R + 1 + W + A)
    staged = g.statics_bytes if g.statics_in_smem else 0
    assert g.smem_bytes == staged + L * g.lane_bytes <= limit
    assert g.statics_in_smem == (case != "s24000")
    assert P == 1 or L <= ffd_kernels.MAX_NAMED_LANES
    if case == "cap15":
        assert (L, P) == (ffd_kernels.MAX_NAMED_LANES, 2)
    if case == "config3":
        assert g.lane_bytes == 1952 and (L, P) == (4, 8)


@pytest.mark.parametrize("n", [2, 4, 5])
@pytest.mark.parametrize("S", [2560, 24000])
def test_chunk_geometry(S, n):
    """B3 stages one chunk's statics at a time: its geometry is B1's at
    the chunk width ceil(S/n), statics and bitmap alike, so a pool past
    shared memory is staged chunk by chunk once its chunks fit."""
    C, K, R, W, A = 2560, 32, 4, 1, 2
    limit = ffd_kernels.H100_SMEM_LIMIT
    Sc = -(-S // n)
    g = ffd_kernels.launch_geometry(C, K, Sc, R, W, A, limit, False)
    whole = ffd_kernels.launch_geometry(C, K, S, R, W, A, limit, False)
    assert g.warps_per_lane == 1
    assert g.statics_bytes == 4 * Sc * (R + 1 + W + A)
    assert g.lane_bytes == 4 * (K * (2 * R + W + 2 * A + 3) + -(-Sc // 32) + 4)
    assert g.smem_bytes <= limit
    assert g.statics_in_smem == (S == 2560 or n >= 4)
    assert whole.statics_in_smem == (S == 2560)
    if whole.statics_in_smem:  # a chunk leaves room for as many lanes
        assert g.lanes_per_block >= whole.lanes_per_block


STRESS = overlay_stress_packs(0)


@pytest.mark.parametrize("name", list(STRESS), ids=str)
def test_overlay_stress_packs_stress_what_they_name(name):
    """Each stress pack has the shape and the placements it is named
    for (plain first-fit and best-fit on the CPU)."""
    host = STRESS[name]
    packed = to_device(host, "cpu")
    C, K, R = host.slot_req.shape
    S = host.spot_free.shape[0]
    ff = plan_ffd(packed)
    bf = plan_ffd(packed, best_fit=True)
    assert int(ff.feasible.sum()) > 0 and int(bf.feasible.sum()) > 0
    if name == "one_spot":
        placed = ff.assignment[ff.assignment >= 0]
        assert S == 3 and bool((placed == 0).all()) and placed.numel() > K
    elif name == "k130":
        assert K == 130
    elif name == "ragged_spots":
        assert S % 32 == 1
    elif name == "ragged_lanes":
        for best_fit in (False, True):
            g = ffd_kernels.launch_geometry(
                C, K, S, R, 1, 2, ffd_kernels.H100_SMEM_LIMIT, best_fit
            )
            assert C % g.lanes_per_block != 0
    elif name == "invalid_blocks":
        assert int(host.cand_valid.sum()) == 2 and C == 600
    elif name == "later_window":
        want = [[5, 5, 70, 70], [5, 70, 70, 70], [-1, -1, -1, -1],
                [5, 5, 70, 70]]
        assert ff.assignment.tolist() == want
        assert bf.assignment.tolist() == want
        assert ff.feasible.tolist() == [True, True, False, True]
    if name in STRESS_LAYOUTS:
        assert tuple(carry_layout(host)) == STRESS_LAYOUTS[name]
    if name == "k_distinct":  # lane 0 touches K distinct spots
        for res in (ff, bf):
            assert bool(res.feasible[0])
            assert len(set(res.assignment[0].tolist())) == K
        assert K > 32
    elif name in ("dcount_guard", "used_int16_edge", "used_uint16_edge"):
        # every pod of lane 0 on the one spot that fits: dcount reaches
        # K, used K * req
        for res in (ff, bf):
            placed = res.assignment[0]
            assert bool(res.feasible[0]) and len(set(placed.tolist())) == 1
        req = float(host.slot_req[0, 0, 0])
        used = {"dcount_guard": None, "used_int16_edge": 32767.0,
                "used_uint16_edge": 65535.0}[name]
        if used is None:
            assert K == np.iinfo(np.int8).max
        else:
            assert K * req == used
    elif name.startswith("aff_bit"):
        top = int(name[len("aff_bit"):])
        bits = host.slot_aff.astype(np.uint64)
        assert int(bits.max()) == 1 << top
        # pods that share the top bit never share a spot in a lane
        for res in (ff, bf):
            clash = 0
            for c in range(C):
                spots = [int(s) for s, w in zip(res.assignment[c],
                                                host.slot_aff[c, :, 1])
                         if s >= 0 and w == 1 << top]
                clash += len(spots) - len(set(spots))
                assert len(spots) == len(set(spots))
            assert clash == 0


@pytest.mark.parametrize("layout", LAYOUTS[::5], ids=str)
def test_stream_wrappers_take_the_plain_version_on_cpu_tensors(layout):
    packed = to_device(_layout_pack(3, layout), "cpu")
    before = dict(ffd_kernels.LAUNCHES)
    for n in (1, 3):
        _assert_same(
            ffd_kernels.plan_stream_bf_kernel(packed, carry_chunks=n, layout=layout),
            plan_ffd(packed, best_fit=True),
        )
        _assert_same(
            ffd_kernels.plan_stream_ff_kernel(packed, carry_chunks=n, layout=layout),
            plan_ffd(packed),
        )
    assert ffd_kernels.LAUNCHES == before


def test_stream_raw_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        ffd_kernels.launch_stream_raw(
            to_device(_host_pack(0), "cpu"), CarryLayout()
        )


# --- the kernels on the card ----------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True])
@pytest.mark.parametrize("seed", range(12))
def test_kernel_matches_plain_on_the_card(cuda_device, seed, best_fit):
    packed = to_device(_host_pack(seed), cuda_device)
    name = "B2" if best_fit else "B1"
    before = ffd_kernels.LAUNCHES[name]
    got = ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit)
    assert ffd_kernels.LAUNCHES[name] == before + 1
    want = plan_ffd(packed, best_fit=best_fit)
    torch.cuda.synchronize()
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1, 2, 3, 64, 256, 640, 866])
def test_chunked_kernel_matches_plain_on_the_card(cuda_device, chunk):
    """B3 is one launch per call, whatever its chunk count, with the raw
    placements of its chunk loop; the widths past 64 run on S=2597, so
    866 leaves a last chunk of 865 spots whose windows straddle."""
    packed = to_device(_host_pack(100 + chunk, S=2597 if chunk > 64 else 0),
                       cuda_device)
    before = ffd_kernels.LAUNCHES["B3"]
    got = ffd_kernels.plan_ffd_chunked(packed, chunk)
    assert ffd_kernels.LAUNCHES["B3"] == before + 1
    torch.cuda.synchronize()
    _assert_same(got, ffd_kernels.plan_ffd_chunked_plain(packed, chunk))
    _assert_same(got, plan_ffd(packed))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_chunked_kernel_past_shared_memory_on_the_card(cuda_device, n):
    """S=24,000 at R=4: two chunks of 12,000 spots pass a block's shared
    memory and are read from device memory; four of 6,000 are staged
    chunk by chunk."""
    packed = to_device(_host_pack(9, S=24000, R=4), cuda_device)
    chunk = -(-24000 // n)
    g = ffd_kernels.card_geometry(packed, False, spot_chunk=chunk)
    assert g.statics_in_smem == (n == 4)
    got = ffd_kernels.plan_ffd_chunked(packed, chunk)
    torch.cuda.synchronize()
    _assert_same(got, ffd_kernels.plan_ffd_chunked_plain(packed, chunk))


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True])
def test_lane_state_past_shared_memory_on_the_card(cuda_device, best_fit):
    """R=4, W=1, A=2 and S=9000 make 288,000 B of spot statics, past a
    block's shared memory: the kernel reads them from device memory,
    while each lane's overlay stays in shared memory."""
    packed = to_device(_host_pack(7, S=9000, R=4), cuda_device)
    assert not ffd_kernels.card_geometry(packed, best_fit).statics_in_smem
    got = ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit)
    torch.cuda.synchronize()
    _assert_same(got, plan_ffd(packed, best_fit=best_fit))


@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4"])
def test_past_smem_pack_passes_shared_memory(kernel):
    """One lane of ``past_smem_pack`` passes a block's shared memory for
    each kernel (B3 at 2 chunks, B4 at the pack's own carry layout), so
    every launch carves its lanes from the workspace."""
    C, K, S, R, W, A = PAST_SMEM_SHAPE
    packed = past_smem_pack(0)
    assert packed.slot_req.shape == (C, K, R)
    assert packed.spot_taints.shape == (S, W)
    layout = carry_layout(packed) if kernel == "B4" else None
    g = ffd_kernels.launch_geometry(
        C, K, -(-S // 2) if kernel == "B3" else S, R, W, A,
        ffd_kernels.H100_SMEM_LIMIT, kernel in ("B2", "B4"), layout=layout,
    )
    assert not g.lanes_in_smem and g.lane_bytes > ffd_kernels.H100_SMEM_LIMIT
    assert g.statics_in_smem and g.smem_bytes == g.statics_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["B1", "B2", "B3", "B4"])
def test_lane_workspace_matches_plain_on_the_card(cuda_device, kernel):
    """Past one lane's shared memory (``past_smem_pack``, K=2,200 at
    W=17) each kernel runs with its lanes in the device-memory workspace,
    bit-identical to its plain version."""
    host = past_smem_pack(0)
    packed = to_device(host, cuda_device)
    before = ffd_kernels.LAUNCHES[kernel]
    if kernel in ("B1", "B2"):
        best_fit = kernel == "B2"
        assert not ffd_kernels.card_geometry(packed, best_fit).lanes_in_smem
        got = ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit)
        want = plan_ffd(packed, best_fit=best_fit)
    elif kernel == "B3":
        chunk = -(-packed.spot_free.shape[0] // 2)
        got = ffd_kernels.plan_ffd_chunked(packed, chunk)
        want = ffd_kernels.plan_ffd_chunked_plain(packed, chunk)
    else:
        layout = carry_layout(host)
        got = ffd_kernels.plan_stream_bf_kernel(packed, carry_chunks=2,
                                                layout=layout)
        want = plan_ffd_streamed(packed, carry_chunks=2, layout=layout,
                                 best_fit=True)
    assert ffd_kernels.LAUNCHES[kernel] == before + 1
    torch.cuda.synchronize()
    _assert_same(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "best_fit, warps",
    [(False, 1), (True, 1), (True, 2), (True, 4), (True, 8)],
    ids=["B1", "B2-P1", "B2-P2", "B2-P4", "B2-P8"],
)
def test_lane_workspace_in_every_geometry(cuda_device, best_fit, warps):
    """B1/B2 and B4 with their lanes forced into the workspace, across
    lanes per block and the statics' place: the same raw answer as with
    the lanes in shared memory."""
    packed = to_device(STRESS["k130"], cuda_device)
    layout = carry_layout(STRESS["k130"])
    C, K, S, R, W, A = 24, 130, 200, 4, 1, 2
    want = ffd_raw(packed, best_fit)
    valid = packed.cand_valid
    for L in (1, 3):
        for in_smem in (True, False):
            g = ffd_kernels.fixed_geometry(K, S, R, W, A, L, warps, in_smem,
                                           lanes_in_smem=False)
            assert g.smem_bytes == (g.statics_bytes if in_smem else 0)
            feasible, chosen = ffd_kernels.launch_raw(packed, best_fit, g)
            torch.cuda.synchronize()
            assert torch.equal(feasible, want[0])
            assert torch.equal(chosen[valid], want[1][valid])
            if not best_fit:
                continue
            g4 = ffd_kernels.fixed_geometry(K, S, R, W, A, L, warps, in_smem,
                                            layout, lanes_in_smem=False)
            feasible, chosen = ffd_kernels.launch_stream_raw(packed, layout,
                                                             g4)
            torch.cuda.synchronize()
            assert torch.equal(feasible, want[0])
            assert torch.equal(torch.where(feasible[:, None], chosen, -1),
                               plan_ffd(packed, best_fit=True).assignment)


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True], ids=["B1", "B2"])
@pytest.mark.parametrize("name", list(STRESS), ids=str)
def test_overlay_stress_on_the_card(cuda_device, name, best_fit):
    """B1/B2's raw outputs (placements after a failed slot included) and
    results are bit-identical to the plain version on each pack that
    stresses the overlay."""
    packed = to_device(STRESS[name], cuda_device)
    if name == "ragged_lanes":
        g = ffd_kernels.card_geometry(packed, best_fit)
        assert packed.slot_req.shape[0] % g.lanes_per_block != 0
    feasible, chosen = ffd_kernels.launch_raw(packed, best_fit)
    want_feasible, want_chosen = ffd_raw(packed, best_fit)
    valid = packed.cand_valid
    torch.cuda.synchronize()
    assert torch.equal(feasible, want_feasible)
    assert torch.equal(chosen[valid], want_chosen[valid])
    assert bool((chosen[~valid] == -1).all())
    _assert_same(ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit),
                 plan_ffd(packed, best_fit=best_fit))


@pytest.mark.cuda
@pytest.mark.parametrize(
    "best_fit, warps",
    [(False, 1), (True, 1), (True, 2), (True, 4), (True, 8)],
    ids=["B1", "B2-P1", "B2-P2", "B2-P4", "B2-P8"],
)
def test_every_geometry_gives_the_same_answer(cuda_device, best_fit, warps):
    """Lanes per block, warps per lane and the statics' place change
    how the kernel runs, never what it computes (first-fit runs one warp
    per lane)."""
    packed = to_device(STRESS["k130"], cuda_device)
    C, K, S, R, W, A = 24, 130, 200, 4, 1, 2
    want = ffd_raw(packed, best_fit)
    for L in (1, 3):
        for in_smem in (True, False):
            g = ffd_kernels.fixed_geometry(K, S, R, W, A, L, warps, in_smem)
            feasible, chosen = ffd_kernels.launch_raw(packed, best_fit, g)
            torch.cuda.synchronize()
            assert torch.equal(feasible, want[0])
            valid = packed.cand_valid
            assert torch.equal(chosen[valid], want[1][valid])


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_stream_kernel_matches_plain_for_every_layout(cuda_device, layout):
    """B4 against its plain version (the streamed best-fit scan) and the
    unstreamed best-fit, for every dtype combination of the carry."""
    packed = to_device(_layout_pack(20, layout), cuda_device)
    before = ffd_kernels.LAUNCHES["B4"]
    got = ffd_kernels.plan_stream_bf_kernel(packed, carry_chunks=3, layout=layout)
    assert ffd_kernels.LAUNCHES["B4"] == before + 1
    torch.cuda.synchronize()
    _assert_same(
        got,
        plan_ffd_streamed(packed, carry_chunks=3, layout=layout, best_fit=True),
    )
    _assert_same(got, plan_ffd(packed, best_fit=True))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [CarryLayout("int16", "int8", "uint8"),
                                    CarryLayout()], ids=str)
def test_stream_kernel_carry_in_device_memory(cuda_device, layout):
    """Past shared memory: at S=24,000 and R=4 the spot statics take
    768,000 B and are read from device memory, while each lane's carry,
    its K overlay entries in the layout's dtypes and its touched bitmap,
    stays in shared memory (no workspace)."""
    big = to_device(
        _layout_pack(22, CarryLayout("int16", "int8", "uint8"), S=24000, R=4),
        cuda_device,
    )
    g = ffd_kernels.card_geometry(big, True, layout=layout)
    assert not g.statics_in_smem
    assert g.smem_bytes == g.lanes_per_block * g.lane_bytes < 8192
    got = ffd_kernels.plan_stream_bf_kernel(big, layout=layout)
    torch.cuda.synchronize()
    _assert_same(got, plan_ffd(big, best_fit=True))
    _assert_same(got, plan_ffd_streamed(big, carry_chunks=3, layout=layout,
                                        best_fit=True))


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(STRESS), ids=str)
def test_stream_kernel_on_the_stress_packs(cuda_device, name):
    """B4 with each stress pack's own carry layout, bit-identical to the
    plain streamed best-fit and to B2."""
    packed = to_device(STRESS[name], cuda_device)
    layout = carry_layout(STRESS[name])
    got = ffd_kernels.plan_stream_bf_kernel(packed, carry_chunks=3,
                                            layout=layout)
    torch.cuda.synchronize()
    _assert_same(got, plan_ffd_streamed(packed, carry_chunks=3, layout=layout,
                                        best_fit=True))
    _assert_same(got, ffd_kernels.plan_ffd_kernel(packed, best_fit=True))


@pytest.mark.cuda
@pytest.mark.parametrize("warps", [1, 2, 4, 8])
def test_every_stream_geometry_gives_the_same_answer(cuda_device, warps):
    """B4 across lanes per block, warps per lane and the statics' place,
    with K=130 entries of int16 counts."""
    packed = to_device(STRESS["k130"], cuda_device)
    layout = carry_layout(STRESS["k130"])
    C, K, S, R, W, A = 24, 130, 200, 4, 1, 2
    want = plan_ffd(packed, best_fit=True)
    for L in (1, 3):
        for in_smem in (True, False):
            g = ffd_kernels.fixed_geometry(K, S, R, W, A, L, warps, in_smem,
                                           layout)
            feasible, chosen = ffd_kernels.launch_stream_raw(packed, layout, g)
            torch.cuda.synchronize()
            assert torch.equal(feasible, want.feasible)
            assert torch.equal(torch.where(feasible[:, None], chosen, -1),
                               want.assignment)


@pytest.mark.cuda
@pytest.mark.parametrize("carry_chunks", [1, 2, 5])
def test_stream_first_fit_on_the_card(cuda_device, carry_chunks):
    """The streamed union's first-fit: B1 for one chunk, B3 for more."""
    packed = to_device(_host_pack(40 + carry_chunks), cuda_device)
    before = dict(ffd_kernels.LAUNCHES)
    got = ffd_kernels.plan_stream_ff_kernel(packed, carry_chunks=carry_chunks)
    name = "B1" if carry_chunks == 1 else "B3"
    assert ffd_kernels.LAUNCHES[name] > before[name]
    torch.cuda.synchronize()
    _assert_same(got, plan_ffd(packed))


# --- B1t/B2t: B1/B2 over a tenant axis -------------------------------------------


def _stacked(T: int, seed: int, C=20, K=6, S=150, R=3, pad: bool = True):
    """T seeded random packs of one shape stacked along a leading tenant
    axis (numpy); with ``pad`` and T > 1 the last tenant is an
    all-invalid pad tenant (invalid lanes, empty slots, no spots)."""
    rng = np.random.default_rng(seed)
    packs = [random_pack(rng, C, K, S, R) for _ in range(T)]
    if pad and T > 1:
        last = packs[-1]
        packs[-1] = PackedCluster(*(np.zeros_like(f) for f in last))
    return PackedCluster(*(
        np.stack([getattr(p, f) for p in packs]) for f in PackedCluster._fields
    ))


def _tenant(stacked, t: int):
    return PackedCluster(*(f[t] for f in stacked))


@pytest.mark.parametrize("T", [1, 3])
def test_tenant_wrapper_takes_the_plain_version_on_cpu_tensors(T):
    stacked = to_device(_stacked(T, 5), "cpu")
    before = dict(ffd_kernels.LAUNCHES)
    for best_fit in (False, True):
        got = ffd_kernels.plan_ffd_tenants_kernel(stacked, best_fit=best_fit)
        assert got.feasible.shape == (T, 20)
        assert got.assignment.shape == (T, 20, 6)
        for t in range(T):
            want = plan_ffd(_tenant(stacked, t), best_fit=best_fit)
            assert torch.equal(got.feasible[t], want.feasible)
            assert torch.equal(got.assignment[t], want.assignment)
    assert ffd_kernels.LAUNCHES == before


def test_tenant_raw_launch_refuses_cpu_and_unstacked_packs():
    with pytest.raises(ValueError, match="CUDA"):
        ffd_kernels.launch_tenants_raw(to_device(_stacked(2, 0), "cpu"),
                                       False)
    with pytest.raises(ValueError, match="stacked"):
        ffd_kernels.launch_tenants_raw(to_device(_host_pack(0), "cpu"), False)


def _check_tenants(stacked, best_fit: bool):
    """One B1t/B2t launch on ``stacked`` (on the card) against its plain
    version and against one solo B1/B2 launch per tenant, results and
    raw outputs."""
    name = "B2t" if best_fit else "B1t"
    before = ffd_kernels.LAUNCHES[name]
    got = ffd_kernels.plan_ffd_tenants_kernel(stacked, best_fit=best_fit)
    assert ffd_kernels.LAUNCHES[name] == before + 1
    raw_feasible, raw_chosen = ffd_kernels.launch_tenants_raw(stacked,
                                                              best_fit)
    plain = ffd_kernels.plan_ffd_tenants_plain(stacked, best_fit)
    torch.cuda.synchronize()
    _assert_same(got, plain)
    for t in range(stacked.slot_req.shape[0]):
        tenant = _tenant(stacked, t)
        solo = ffd_kernels.plan_ffd_kernel(tenant, best_fit=best_fit)
        feasible, chosen = ffd_kernels.launch_raw(tenant, best_fit)
        torch.cuda.synchronize()
        assert torch.equal(got.feasible[t], solo.feasible)
        assert torch.equal(got.assignment[t], solo.assignment)
        assert torch.equal(raw_feasible[t], feasible)
        assert torch.equal(raw_chosen[t], chosen)


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True], ids=["B1t", "B2t"])
@pytest.mark.parametrize("T", [1, 3, 8])
def test_tenant_kernel_matches_solo_launches_and_plain(cuda_device, T,
                                                       best_fit):
    _check_tenants(to_device(_stacked(T, 30 + T), cuda_device), best_fit)


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True], ids=["B1t", "B2t"])
def test_tenant_kernel_statics_in_device_memory(cuda_device, best_fit):
    """S=9000 at R=4: each tenant's statics pass shared memory and are
    read from device memory at the tenant's offset."""
    stacked = to_device(_stacked(3, 8, C=40, K=8, S=9000, R=4), cuda_device)
    g = ffd_kernels.card_geometry(stacked, best_fit, stacked=True)
    assert not g.statics_in_smem
    _check_tenants(stacked, best_fit)


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True], ids=["B1t", "B2t"])
def test_tenant_kernel_past_shared_memory(cuda_device, best_fit):
    """``past_smem_pack`` stacked T=3: every tenant's lanes live in the
    device-memory workspace of G x T x L lanes."""
    stacked = PackedCluster(*(
        np.stack([getattr(past_smem_pack(seed), f) for seed in range(3)])
        for f in PackedCluster._fields
    ))
    stacked = to_device(stacked, cuda_device)
    assert not ffd_kernels.card_geometry(stacked, best_fit,
                                         stacked=True).lanes_in_smem
    _check_tenants(stacked, best_fit)


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True], ids=["B1t", "B2t"])
def test_every_tenant_geometry_gives_the_same_answer(cuda_device, best_fit):
    stacked = to_device(_stacked(4, 17, C=37, K=5, S=300, R=4), cuda_device)
    want = ffd_kernels.plan_ffd_tenants_plain(stacked, best_fit)
    C, K, S, R, W, A = 37, 5, 300, 4, 1, 2
    for warps in ((1, 2, 4, 8) if best_fit else (1,)):
        for L in (1, 3):
            for in_smem in (True, False):
                g = ffd_kernels.fixed_geometry(K, S, R, W, A, L, warps,
                                               in_smem)
                feasible, chosen = ffd_kernels.launch_tenants_raw(
                    stacked, best_fit, g)
                torch.cuda.synchronize()
                assert torch.equal(feasible, want.feasible)
                assert torch.equal(
                    torch.where(feasible[..., None], chosen, -1),
                    want.assignment)
