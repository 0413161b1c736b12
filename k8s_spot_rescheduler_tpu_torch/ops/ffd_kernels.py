"""Wrappers of kernels B1, B2 and B3: the greedy solve on the card.

- **B1** ``plan_ffd_kernel(packed)``: first-fit of every candidate
  lane's pod slots onto the spot pool, CUDA C++ (``csrc/ffd.cu``).
  Replaces the Pallas kernel ``k8s_spot_rescheduler_tpu/ops/
  pallas_ffd.py:85`` ``_kernel`` with ``best_fit=False``.
- **B2** ``plan_ffd_kernel(packed, best_fit=True)``: the same source
  with the best-fit election (least primary-resource slack, ties to the
  lowest index); ``_kernel`` with ``best_fit=True``.
- **B3** ``plan_ffd_chunked(packed, spot_chunk)``: first-fit over
  ordered spot chunks, one B1 launch per chunk with ``slot_valid``
  masked to the pods still unplaced and indices offset by the chunk's
  start; replaces ``pallas_ffd.py:351`` ``_plan_ffd_chunked``. Exact
  for first-fit: per-spot state is independent across chunks and
  first-fit prefers earlier spots.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version (``solver/ffd``), and only
then. ``LAUNCHES`` counts kernel launches per wrapper (one per launch,
nowhere else), so a run can show its main path went through the
kernels.

Build: ``nvcc`` compiles ``csrc/ffd.cu`` for ``sm_90a`` into a shared
library with a plain C interface under ``build/torch_kernels/`` at the
repo root, at first use, keyed by the source's hash; ``ctypes`` loads
it. Tensor pointers and PyTorch's current stream are passed as
integers; the C function returns the launch's ``cudaError_t``.
``LAUNCH_ARGS`` lists ``ffd_launch``'s parameters in their C order and
builds both its ``argtypes`` and each call; a test holds it against the
signature in ``ffd.cu``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

from k8s_spot_rescheduler_tpu_torch.models.tensors import shapes
from k8s_spot_rescheduler_tpu_torch.solver.ffd import ffd_raw, plan_ffd
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult

LAUNCHES = {"B1": 0, "B2": 0, "B3": 0}

SOURCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "csrc", "ffd.cu"
)
REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
BUILD_DIR = os.path.join(REPO_ROOT, "build", "torch_kernels")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
    "-Xptxas=-v",
)

_lib = None
BUILD_LOG = ""  # nvcc's output of the last build (ptxas register use)

_FIELDS = (
    # name, dtype, shape as a function of (C, K, S, R, W, A)
    ("slot_req", torch.float32, lambda C, K, S, R, W, A: (C, K, R)),
    ("slot_valid", torch.bool, lambda C, K, S, R, W, A: (C, K)),
    ("slot_tol", torch.int32, lambda C, K, S, R, W, A: (C, K, W)),
    ("slot_aff", torch.int32, lambda C, K, S, R, W, A: (C, K, A)),
    ("cand_valid", torch.bool, lambda C, K, S, R, W, A: (C,)),
    ("spot_free", torch.float32, lambda C, K, S, R, W, A: (S, R)),
    ("spot_count", torch.int32, lambda C, K, S, R, W, A: (S,)),
    ("spot_max_pods", torch.int32, lambda C, K, S, R, W, A: (S,)),
    ("spot_taints", torch.int32, lambda C, K, S, R, W, A: (S, W)),
    ("spot_ok", torch.bool, lambda C, K, S, R, W, A: (S,)),
    ("spot_aff", torch.int32, lambda C, K, S, R, W, A: (S, A)),
)

# ffd_launch's parameters in C order: (name, dtype of the tensor behind
# a pointer, or "int" for an int, or "stream")
LAUNCH_ARGS = (
    *((name, dtype) for name, dtype, _ in _FIELDS),
    ("feasible", torch.bool),
    ("chosen", torch.int32),
    ("workspace", torch.int32),
    *((dim, "int") for dim in ("C", "K", "R", "W", "A", "S", "best_fit")),
    ("stream", "stream"),
)

_SMEM_LIMIT = {}  # device index -> ffd_max_dynamic_smem


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME:
        path = os.path.join(CUDA_HOME, "bin", "nvcc")
        if os.path.exists(path):
            return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels")
    return path


def build() -> str:
    """Compile ``csrc/ffd.cu`` (once per source hash); returns the
    shared library's path. Raises with nvcc's output on failure."""
    global BUILD_LOG
    with open(SOURCE, "rb") as f:
        digest = hashlib.sha256(
            f.read() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
    out = os.path.join(BUILD_DIR, f"libffd_{digest}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    BUILD_LOG = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}"
        )
    os.replace(tmp, out)
    return out


def library():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ffd_launch.argtypes = [
            i32 if kind == "int" else ptr for _, kind in LAUNCH_ARGS
        ]
        lib.ffd_launch.restype = i32
        lib.ffd_max_dynamic_smem.argtypes = [i32]
        lib.ffd_max_dynamic_smem.restype = i32
        lib.ffd_state_bytes.argtypes = [i32, i32, i32]
        lib.ffd_state_bytes.restype = ctypes.c_longlong
        lib.ffd_error_string.argtypes = [i32]
        lib.ffd_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(packed) -> None:
    dims = shapes(packed)
    dev = packed.slot_req.device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be on a CUDA device, not {dev}")
    for name, dtype, shape_fn in _FIELDS:
        t = getattr(packed, name)
        want = shape_fn(*dims)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(
                f"{name}: want {dtype} {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def state_fits_smem(R: int, A: int, S: int, device_index: int) -> bool:
    """Whether one lane's state (R+1+A planes of S words) fits the
    dynamic shared memory a block may take on the card (read once per
    device)."""
    lib = library()
    limit = _SMEM_LIMIT.get(device_index)
    if limit is None:
        limit = lib.ffd_max_dynamic_smem(device_index)
        if limit < 0:
            raise RuntimeError("cannot read the card's shared-memory limit")
        _SMEM_LIMIT[device_index] = limit
    return lib.ffd_state_bytes(R, A, S) <= limit


def launch_raw(packed, best_fit: bool):
    """One kernel launch, uncounted: (feasible bool [C], chosen int32
    [C, K] with -1 for unplaced slots, NOT masked by lane feasibility;
    lanes with cand_valid=0 report feasible=0 and chosen=-1). The lane
    state lives in shared memory where it fits (``state_fits_smem``),
    else in a device-memory workspace allocated here."""
    _check(packed)
    lib = library()
    C, K, S, R, W, A = shapes(packed)
    dev = packed.slot_req.device
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    feasible = torch.empty((C,), dtype=torch.bool, device=dev)
    chosen = torch.empty((C, K), dtype=torch.int32, device=dev)
    workspace = None
    if not state_fits_smem(R, A, S, index):
        # the lane state does not fit shared memory: hold it in device
        # memory (same kernel source)
        workspace = torch.empty(
            (C * (R + 1 + A) * S,), dtype=torch.int32, device=dev
        )
    with torch.cuda.device(index):
        args = {name: getattr(packed, name).data_ptr() for name, _, _ in _FIELDS}
        args.update(
            feasible=feasible.data_ptr(),
            chosen=chosen.data_ptr(),
            workspace=None if workspace is None else workspace.data_ptr(),
            C=C, K=K, R=R, W=W, A=A, S=S,
            best_fit=int(best_fit),
            stream=torch.cuda.current_stream(index).cuda_stream,
        )
        err = lib.ffd_launch(*(args[name] for name, _ in LAUNCH_ARGS))
    if err != 0:
        raise RuntimeError(
            f"ffd kernel launch failed: {lib.ffd_error_string(err).decode()}"
        )
    return feasible, chosen


def plan_ffd_kernel(packed, best_fit: bool = False) -> SolveResult:
    """B1 (first-fit) or B2 (``best_fit``): the contract of
    ``solver/ffd.plan_ffd``. CPU tensors take the plain version."""
    if not packed.slot_req.is_cuda:
        return plan_ffd(packed, best_fit=best_fit)
    feasible, chosen = launch_raw(packed, best_fit)
    LAUNCHES["B2" if best_fit else "B1"] += 1
    assignment = torch.where(feasible[:, None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def _chunk_loop(packed, spot_chunk: int, raw_fn) -> SolveResult:
    """First-fit over ordered spot chunks of ``spot_chunk`` spots, each
    a ``raw_fn(sub) -> (feasible, chosen)`` first-fit pass over the pods
    still unplaced."""
    C, K = packed.slot_req.shape[:2]
    S = packed.spot_free.shape[0]
    remaining = packed.slot_valid
    chosen_total = torch.full(
        (C, K), -1, dtype=torch.int32, device=packed.slot_req.device
    )
    for off in range(0, S, spot_chunk):
        end = min(off + spot_chunk, S)
        sub = packed._replace(
            slot_valid=remaining,
            spot_free=packed.spot_free[off:end],
            spot_count=packed.spot_count[off:end],
            spot_max_pods=packed.spot_max_pods[off:end],
            spot_taints=packed.spot_taints[off:end],
            spot_ok=packed.spot_ok[off:end],
            spot_aff=packed.spot_aff[off:end],
        )
        _, chosen_b = raw_fn(sub)
        placed_b = chosen_b >= 0
        chosen_total = torch.where(placed_b, chosen_b + off, chosen_total)
        remaining = remaining & ~placed_b
    # a lane is feasible iff nothing valid remains unplaced
    feasible = packed.cand_valid & ~remaining.any(dim=1)
    assignment = torch.where(feasible[:, None], chosen_total, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def plan_ffd_chunked_plain(packed, spot_chunk: int) -> SolveResult:
    """B3's plain version: the chunk loop around ``solver/ffd.ffd_raw``."""
    return _chunk_loop(packed, spot_chunk, lambda sub: ffd_raw(sub, False))


def plan_ffd_chunked(packed, spot_chunk: int) -> SolveResult:
    """B3: first-fit over spot chunks of ``spot_chunk`` spots, one B1
    launch per chunk. CPU tensors take the plain version."""
    if not packed.slot_req.is_cuda:
        return plan_ffd_chunked_plain(packed, spot_chunk)

    def raw(sub):
        out = launch_raw(sub, False)
        LAUNCHES["B3"] += 1
        return out

    return _chunk_loop(packed, spot_chunk, raw)


def greedy_solver(spot_chunk: int = 0):
    """The union's greedy pass, ``solve(packed, best_fit=False)``: B2 for
    best-fit; B1 for first-fit, or B3 when ``spot_chunk`` > 0."""

    def solve(packed, best_fit: bool = False) -> SolveResult:
        if best_fit or spot_chunk <= 0:
            return plan_ffd_kernel(packed, best_fit=best_fit)
        return plan_ffd_chunked(packed, spot_chunk)

    return solve
