"""Kernels B1-B4 against their plain PyTorch versions.

This file imports torch, numpy and the port only, never jax, so it also
runs on a machine with a card and no jax (skipping the jax-importing
``conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels.py -q

Without a card the ``cuda``-marked tests skip and the rest check the
wrappers' CPU path: the plain version, and no launch.
"""

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
    plan_ffd,
    plan_ffd_streamed,
)

torch.set_num_threads(1)


def _host_pack(seed: int, S: int = 0, R: int = 0) -> PackedCluster:
    """A seeded random host pack over every predicate, with integral
    capacities from a small range so best-fit ties are common."""
    rng = np.random.default_rng(seed)
    C = int(rng.integers(1, 24))
    K = int(rng.integers(1, 9))
    S = S or int(rng.integers(1, 300))
    R = R or int(rng.integers(1, 5))
    W, A = 1, 2

    def bits(shape):
        return (
            (np.uint32(1) << rng.integers(0, 32, shape).astype(np.uint32))
            * (rng.random(shape) < 0.3)
        ).astype(np.uint32)

    return PackedCluster(
        slot_req=rng.integers(0, 60, (C, K, R)).astype(np.float32) * 10,
        slot_valid=rng.random((C, K)) < 0.8,
        slot_tol=rng.integers(0, 4, (C, K, W)).astype(np.uint32),
        slot_aff=bits((C, K, A)),
        cand_valid=rng.random((C,)) < 0.9,
        spot_free=rng.integers(-10, 150, (S, R)).astype(np.float32) * 10,
        spot_count=rng.integers(0, 5, (S,)).astype(np.int32),
        spot_max_pods=rng.integers(1, 12, (S,)).astype(np.int32),
        spot_taints=rng.integers(0, 4, (S, W)).astype(np.uint32),
        spot_ok=rng.random((S,)) < 0.9,
        spot_aff=bits((S, A)),
    )


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
    slot_aff = (
        (np.uint32(1) << rng.integers(0, top, (C, K, A)).astype(np.uint32))
        * (rng.random((C, K, A)) < 0.3)
    ).astype(np.uint32)
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
    source: editing one source renames its library alone, so the next
    build compiles it again."""
    sources = {}
    for name in ffd_kernels.SOURCES:
        sources[name] = tmp_path / f"{name}.cu"
        sources[name].write_text(f"// {name}\n")
    monkeypatch.setattr(ffd_kernels, "SOURCES", {
        name: str(path) for name, path in sources.items()
    })
    before = {name: ffd_kernels._library_path(name) for name in sources}
    sources["stream_bf"].write_text("// stream_bf, edited\n")
    after = {name: ffd_kernels._library_path(name) for name in sources}
    assert after["ffd"] == before["ffd"]
    assert after["stream_bf"] != before["stream_bf"]
    assert len(set(after.values())) == len(sources)


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
@pytest.mark.parametrize("chunk", [1, 2, 3, 64])
def test_chunked_kernel_matches_plain_on_the_card(cuda_device, chunk):
    packed = to_device(_host_pack(100 + chunk), cuda_device)
    S = packed.spot_free.shape[0]
    before = ffd_kernels.LAUNCHES["B3"]
    got = ffd_kernels.plan_ffd_chunked(packed, chunk)
    assert ffd_kernels.LAUNCHES["B3"] == before + -(-S // chunk)
    torch.cuda.synchronize()
    _assert_same(got, ffd_kernels.plan_ffd_chunked_plain(packed, chunk))
    _assert_same(got, plan_ffd(packed))


@pytest.mark.cuda
@pytest.mark.parametrize("best_fit", [False, True])
def test_lane_state_past_shared_memory_on_the_card(cuda_device, best_fit):
    """R=4, A=2 and S=9000 make 252,000 B of lane state, past a
    block's shared memory: the kernel keeps it in device memory."""
    packed = to_device(_host_pack(7, S=9000, R=4), cuda_device)
    device_index = torch.cuda.current_device()
    assert not ffd_kernels.state_fits_smem(4, 2, 9000, device_index)
    got = ffd_kernels.plan_ffd_kernel(packed, best_fit=best_fit)
    torch.cuda.synchronize()
    _assert_same(got, plan_ffd(packed, best_fit=best_fit))


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
    """The workspace path: at S=24,000 config 3's layout takes 264 KB a
    lane and the wide one 672 KB, past a block's shared memory."""
    big = to_device(
        _layout_pack(22, CarryLayout("int16", "int8", "uint8"), S=24000, R=4),
        cuda_device,
    )
    index = torch.cuda.current_device()
    assert not ffd_kernels.stream_state_fits_smem(layout, 4, 2, 24000, index)
    _assert_same(
        ffd_kernels.plan_stream_bf_kernel(big, layout=layout),
        plan_ffd(big, best_fit=True),
    )


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
