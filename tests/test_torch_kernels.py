"""Kernels B1/B2/B3 against their plain PyTorch versions.

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
from k8s_spot_rescheduler_tpu_torch.solver.ffd import plan_ffd

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


def test_launch_args_match_the_c_signature():
    """The ctypes call is built from LAUNCH_ARGS; no compiler checks it
    against ffd.cu, so this does: names, order, pointer or int, and the
    element type behind each pointer."""
    with open(ffd_kernels.SOURCE) as f:
        params = _c_params(f.read(), "ffd_launch")
    c_types = {
        "float*": torch.float32,
        "uint8_t*": torch.bool,
        "int32_t*": torch.int32,
        "int": "int",
        "void*": "stream",
    }
    assert [(name, c_types[ctype]) for name, ctype in params] == list(
        ffd_kernels.LAUNCH_ARGS
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
