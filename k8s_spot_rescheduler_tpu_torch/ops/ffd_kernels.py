"""Wrappers of kernels B1-B4: the greedy solve on the card.

- **B1** ``plan_ffd_kernel(packed)``: first-fit of every candidate
  lane's pod slots onto the spot pool, CUDA C++ (``csrc/ffd.cu``).
  Replaces the Pallas kernel ``k8s_spot_rescheduler_tpu/ops/
  pallas_ffd.py:85`` ``_kernel`` with ``best_fit=False``.
- **B2** ``plan_ffd_kernel(packed, best_fit=True)``: the same source
  with the best-fit election (least primary-resource slack, ties to the
  lowest index); ``_kernel`` with ``best_fit=True``. B1 and B2 share the
  spot statics of a block and keep per lane only an overlay of the
  spots it touched; ``launch_geometry`` picks their launch shape.
- **B3** ``plan_ffd_chunked(packed, spot_chunk)``: first-fit over
  ordered spot chunks in one launch of B1's kernel, which walks the
  chunks as its outer loop, each chunk's statics staged once per block
  and offered the pods still unplaced, indices offset by the chunk's
  start; replaces ``pallas_ffd.py:351`` ``_plan_ffd_chunked``. Exact
  for first-fit: per-spot state is independent across chunks and
  first-fit prefers earlier spots. It is the carry-streamed union's
  first-fit over more than one chunk (``plan_stream_ff_kernel``).
- **B4** ``plan_stream_bf_kernel(packed, carry_chunks=, layout=)``: the
  fused best-fit elect-then-commit over the narrow delta carry, CUDA
  C++ (``csrc/stream_bf.cu``) on B2's design, the overlay's entries
  holding the carry in the layout's dtypes; replaces
  ``pallas_ffd.py:191`` ``_stream_kernel`` (entry
  ``plan_stream_bf_pallas``), the carry-streamed union's best-fit pass.
- **B5** ``plan_repair_kernel(packed, unproven, rounds, chain)``: repair's
  partial best-fit pass and its ``rounds`` eject-and-reinsert rounds
  (``solver/repair.plan_repair`` before its validation) in one launch,
  CUDA C++ (``csrc/repair.cu``) on B2's design, on the lanes
  ``unproven`` marks, then the plain from-scratch validation; replaces
  no Pallas kernel (the JAX package leaves repair to XLA). Its plain
  version is ``plan_repair_plain``: best-fit's greedy pass
  (``solver/ffd.greedy_pass``) then ``solver/repair.repair_from``.
- **B1t**/**B2t** ``plan_ffd_tenants_kernel(stacked, best_fit)``: B1/B2
  over T problems of one shape stacked along a leading tenant axis, in
  one launch of the same kernel over a (lane block, tenant) grid: the
  planner service's batched greedy passes (``parallel/tenant_batch``).
  The JAX package ``vmap``s its union over the tenant axis
  (``parallel/tenant_batch.py:60``), whose greedy passes are the XLA
  scan or ``_kernel``; its plain version is ``plan_ffd`` per tenant.

B1-B5 share their lane solve (``csrc/greedy.cuh``); ``launch_geometry``
picks B1-B4's launch shape and ``repair_geometry`` B5's. A lane's state
lives in shared memory, or, where one lane alone passes a block's
shared memory, in a device-memory workspace the wrapper allocates for
the launch, so the kernels answer at every shape, as the JAX package
does.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs the plain PyTorch version (``solver/ffd``,
``solver/repair``), and only then. ``LAUNCHES`` counts kernel
launches per wrapper (one per launch, nowhere else), so a run can show
its main path went through the kernels; a stacked launch counts once,
as B1t or B2t.

Build: ``nvcc`` compiles each source in ``SOURCES`` for ``sm_90a`` into
a shared library with a plain C interface under ``build/torch_kernels/``
at the repo root, at first use, keyed by the hash of that source, the
``HEADERS`` it may include and the flags; the sources build in
parallel, one ``nvcc`` each, and ``ctypes`` loads them. Tensor pointers and PyTorch's current stream are
passed as integers; each launch function returns the launch's
``cudaError_t``. ``LAUNCH_ARGS``, ``STREAM_LAUNCH_ARGS`` and
``REPAIR_LAUNCH_ARGS`` list ``ffd_launch``'s, ``stream_bf_launch``'s and
``repair_launch``'s parameters in their C order and build both the
``argtypes`` and each call; a test holds them against the signatures in
the sources.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import NamedTuple

import torch

from k8s_spot_rescheduler_tpu_torch.models.tensors import shapes, tenant_slice
from k8s_spot_rescheduler_tpu_torch.solver.carry import NARROW_LAYOUT
from k8s_spot_rescheduler_tpu_torch.solver.ffd import (
    ffd_raw,
    greedy_pass,
    plan_ffd,
    plan_ffd_streamed,
)
from k8s_spot_rescheduler_tpu_torch.solver.repair import (
    plan_repair,
    repair_from,
    validated,
)
from k8s_spot_rescheduler_tpu_torch.solver.result import SolveResult
from k8s_spot_rescheduler_tpu_torch.utils import tracing

LAUNCHES = {"B1": 0, "B2": 0, "B3": 0, "B4": 0, "B1t": 0, "B2t": 0,
            "B5": 0}

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
SOURCES = {  # library name -> its one source
    "ffd": os.path.join(CSRC, "ffd.cu"),
    "stream_bf": os.path.join(CSRC, "stream_bf.cu"),
    "repair": os.path.join(CSRC, "repair.cu"),
}
HEADERS = (os.path.join(CSRC, "greedy.cuh"),)  # included by every source
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

_libs = {}  # library name -> loaded ctypes library
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
    ("lane_ws", torch.int32),
    *((dim, "int") for dim in (
        "C", "K", "R", "W", "A", "S", "spot_chunk", "best_fit",
        "lanes_per_block", "warps_per_lane", "statics_in_smem", "smem_bytes",
        "lane_ws_words", "tenants",
    )),
    ("stream", "stream"),
)

# stream_bf_launch's parameters in C order, as LAUNCH_ARGS
STREAM_LAUNCH_ARGS = (
    *((name, dtype) for name, dtype, _ in _FIELDS),
    ("feasible", torch.bool),
    ("chosen", torch.int32),
    ("lane_ws", torch.int32),
    *((dim, "int") for dim in (
        "C", "K", "R", "W", "A", "S", "used_code", "count_code", "aff_code",
        "lanes_per_block", "warps_per_lane", "statics_in_smem", "smem_bytes",
        "lane_ws_words",
    )),
    ("stream", "stream"),
)

# repair_launch's parameters in C order, as LAUNCH_ARGS: B1-B4's inputs
# with ``unproven`` (the lanes to repair) in place of ``cand_valid``
REPAIR_LAUNCH_ARGS = (
    *((name, dtype) if name != "cand_valid" else ("unproven", dtype)
      for name, dtype, _ in _FIELDS),
    ("assign", torch.int32),
    ("lane_ws", torch.int32),
    *((dim, "int") for dim in (
        "C", "K", "R", "W", "A", "S", "rounds", "chain", "lanes_per_block",
        "warps_per_lane", "statics_in_smem", "smem_bytes", "lane_ws_words",
    )),
    ("stream", "stream"),
)

# stream_bf.cu's code of each plane dtype a CarryLayout names
USED_CODES = {"int16": 0, "uint16": 1, "float32": 2}
COUNT_CODES = {"int8": 0, "int16": 1, "int32": 2}
AFF_CODES = {"uint8": 0, "uint16": 1, "uint32": 2}
_ITEMSIZE = {"int8": 1, "uint8": 1, "int16": 2, "uint16": 2, "int32": 4,
             "uint32": 4, "float32": 4}

_SMEM_LIMIT = {}  # (library name, device index) -> its max dynamic smem
_SM_COUNT = {}  # device index -> its streaming multiprocessors

H100_SMS = 132
H100_SMEM_LIMIT = 232_448  # dynamic shared memory a block may opt into
WARPS_PER_LANE = (8, 4, 2, 1)  # B2's and B4's choices, widest first
MAX_NAMED_LANES = 15  # bar.sync ids 1..15: lanes of more than one warp
# the fewest warps a block takes when its lanes allow: the statics are
# staged by every thread of the block
STAGING_WARPS = 8


class FfdGeometry(NamedTuple):
    """How B1-B4 launch (``launch_geometry``): ``lanes_per_block`` lanes
    of ``warps_per_lane`` warps share a block; the spot statics of one
    chunk (``statics_bytes``) sit in its shared memory or are read from
    device memory; each lane takes ``lane_bytes`` (slot rows, overlay,
    touched bitmap, partials), in shared memory after the statics or,
    when ``lanes_in_smem`` is False, in a device-memory workspace of
    grid x lanes a block lanes that the wrapper allocates;
    ``smem_bytes`` is the block's dynamic shared memory."""

    lanes_per_block: int
    warps_per_lane: int
    statics_in_smem: bool
    smem_bytes: int
    statics_bytes: int
    lane_bytes: int
    lanes_in_smem: bool = True

    @property
    def threads(self) -> int:
        return 32 * self.lanes_per_block * self.warps_per_lane


def overlay_words(K: int, R: int, A: int, layout=None) -> int:
    """32-bit words of a lane's K overlay entries: B1-B3's absolute free
    [R], room and aff [A] (``layout`` None), or B4's deltas in
    ``layout``'s dtypes, used [R][K], dcount [K] and daff [A][K], each
    plane padded to a word (``greedy.cuh`` ``DeltaOverlay``)."""
    if layout is None:
        return K * (R + 1 + A)
    return (-(-R * K * _ITEMSIZE[layout.used] // 4)
            + -(-K * _ITEMSIZE[layout.count] // 4)
            + -(-A * K * _ITEMSIZE[layout.aff] // 4))


@functools.lru_cache(maxsize=256)
def launch_geometry(
    C: int, K: int, S: int, R: int, W: int, A: int, smem_limit: int,
    best_fit: bool, n_sm: int = H100_SMS, layout=None,
) -> FfdGeometry:
    """The launch shape of B1 (``best_fit=False``), B2, or B4 (best-fit
    with its carry ``layout``) over C lanes of K slots and S spots (for
    B3, S is its chunk width: a block holds one chunk's statics at a
    time), for blocks of at most ``smem_limit`` bytes of dynamic shared
    memory (``ffd_max_dynamic_smem``, ``stream_bf_max_dynamic_smem``) on
    ``n_sm`` SMs.

    First-fit runs one warp per lane (``warps_per_lane`` 1); best-fit
    the most of 8, 4, 2, 1 warps that has a window of 32 spots for each.
    A lane's state is its slot rows and entry indices (K*(R+W+A+2)
    words), its overlay (``overlay_words``), its touched bitmap
    (ceil(S/32) words) and best-fit's partials (4P words). The statics
    (S*(R+1+W+A) words) go in shared memory when they fit beside one
    lane, else the kernel reads them from device memory. Lanes per
    block: as many as shared memory and 1,024 threads allow (at most 15
    when a lane has several warps) and no more than C, but no more than
    ceil(C/n_sm) either, so the lanes spread over every SM, unless that
    leaves fewer than ``STAGING_WARPS`` warps to stage the statics.

    When one lane's state alone exceeds ``smem_limit`` (K in the
    thousands), the lanes live in a device-memory workspace
    (``lanes_in_smem`` False): shared memory then holds the statics
    where they fit, and only threads and the spread bound the lanes a
    block."""
    P = _best_fit_warps(S) if best_fit else 1
    one = fixed_geometry(K, S, R, W, A, 1, P, True, layout)
    if one.lane_bytes > smem_limit:
        return fixed_geometry(K, S, R, W, A, _lanes_a_block(C, P, n_sm), P,
                              one.statics_bytes <= smem_limit, layout,
                              lanes_in_smem=False)
    in_smem = one.smem_bytes <= smem_limit
    base = one.statics_bytes if in_smem else 0
    L = _lanes_a_block(C, P, n_sm, (smem_limit - base) // one.lane_bytes)
    return fixed_geometry(K, S, R, W, A, L, P, in_smem, layout)


def _best_fit_warps(S: int) -> int:
    """Warps a best-fit lane takes: the most of 8, 4, 2, 1 that has a
    window of 32 spots for each."""
    return next(p for p in WARPS_PER_LANE if p <= max(1, -(-S // 32)))


def _lanes_a_block(C: int, P: int, n_sm: int, fit: int = 32) -> int:
    """Lanes of P warps a block: at most ``fit`` (what shared memory
    holds), 1,024 threads, 15 when a lane has several warps, and
    ceil(C / n_sm), unless that leaves fewer than ``STAGING_WARPS``
    warps; at least one."""
    spread = min(C, max(-(-C // n_sm), STAGING_WARPS // P))
    L = min(fit, 32 // P, spread)
    if P > 1:
        L = min(L, MAX_NAMED_LANES)
    return max(1, L)


@functools.lru_cache(maxsize=256)
def repair_geometry(
    C: int, K: int, S: int, R: int, W: int, A: int, rounds: int,
    smem_limit: int, n_sm: int = H100_SMS,
) -> FfdGeometry:
    """B5's launch shape over C lanes of K slots and S spots with
    ``rounds`` rounds, as B2's (``launch_geometry``): best-fit's warps a
    lane, the statics in shared memory when they fit beside one lane,
    lanes a block as shared memory, threads and the spread allow. Where
    one lane alone passes ``smem_limit``, the lanes live in the
    device-memory workspace (``lanes_in_smem`` False) and shared memory
    holds the statics where they fit."""
    P = _best_fit_warps(S)
    one = fixed_repair_geometry(K, S, R, W, A, rounds, 1, P, True)
    if one.lane_bytes > smem_limit:
        return fixed_repair_geometry(
            K, S, R, W, A, rounds, _lanes_a_block(C, P, n_sm), P,
            one.statics_bytes <= smem_limit, lanes_in_smem=False)
    in_smem = one.smem_bytes <= smem_limit
    base = one.statics_bytes if in_smem else 0
    L = _lanes_a_block(C, P, n_sm, (smem_limit - base) // one.lane_bytes)
    return fixed_repair_geometry(K, S, R, W, A, rounds, L, P, in_smem)


def fixed_repair_geometry(K: int, S: int, R: int, W: int, A: int,
                          rounds: int, lanes: int, warps: int,
                          statics_in_smem: bool, *,
                          lanes_in_smem: bool = True) -> FfdGeometry:
    """B5's geometry of ``lanes`` lanes of ``warps`` warps a block, the
    statics in shared memory or not and the lanes in shared memory or in
    the device-memory workspace, its bytes counted as ``repair_launch``
    counts them: a lane is B2's over K + ``rounds`` overlay entries (its
    slot rows padded to as many), then the assignment [K] and each
    slot's entry [K] (``csrc/repair.cu`` ``repair_lane_words``)."""
    E = K + rounds
    lane_bytes = 4 * (E * (R + W + A + 2) + overlay_words(E, R, A)
                      + -(-S // 32) + 4 * warps + 2 * K)
    statics_bytes = 4 * S * (R + 1 + W + A)
    base = statics_bytes if statics_in_smem else 0
    lanes_smem = lanes * lane_bytes if lanes_in_smem else 0
    return FfdGeometry(lanes, warps, statics_in_smem, base + lanes_smem,
                       statics_bytes, lane_bytes, lanes_in_smem)


def fixed_geometry(K: int, S: int, R: int, W: int, A: int, lanes: int,
                   warps: int, statics_in_smem: bool,
                   layout=None, *, lanes_in_smem: bool = True) -> FfdGeometry:
    """The geometry of ``lanes`` lanes of ``warps`` warps a block with the
    statics in shared memory or not and the lanes in shared memory or
    in the device-memory workspace, for B1-B3 (``layout`` None) or B4,
    its bytes counted as the kernel counts them (``ffd_launch`` and
    ``stream_bf_launch`` reject any other ``smem_bytes``)."""
    lane_bytes = 4 * (K * (R + W + A + 2) + overlay_words(K, R, A, layout)
                      + -(-S // 32) + 4 * warps)
    statics_bytes = 4 * S * (R + 1 + W + A)
    base = statics_bytes if statics_in_smem else 0
    lanes_smem = lanes * lane_bytes if lanes_in_smem else 0
    return FfdGeometry(lanes, warps, statics_in_smem, base + lanes_smem,
                       statics_bytes, lane_bytes, lanes_in_smem)


class KernelError(RuntimeError):
    """A kernel of this module could not be built, loaded or launched."""


def is_device_fault(err: BaseException) -> bool:
    """True for a fault of the card's kernels: a ``KernelError``, any
    error raised in this module (a wrapper refusing its inputs, the lane
    workspace not allocated), or a CUDA error that surfaced at a later
    synchronisation (a fault inside a kernel is reported there, not by
    its launch). An injected chaos failure
    (``service/chaos.ServiceChaosError``) is never one, whatever its
    text: the type is checked first."""
    from k8s_spot_rescheduler_tpu_torch.service.chaos import ServiceChaosError

    if isinstance(err, ServiceChaosError):
        return False
    accelerator_error = getattr(torch, "AcceleratorError", None)
    if isinstance(err, KernelError) or (
        accelerator_error is not None and isinstance(err, accelerator_error)
    ):
        return True
    if isinstance(err, RuntimeError) and str(err).startswith("CUDA error"):
        return True
    tb = err.__traceback__
    while tb is not None:
        if tb.tb_frame.f_code.co_filename == __file__:
            return True
        tb = tb.tb_next
    return False


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
        raise KernelError("nvcc not found: cannot build the CUDA kernels")
    return path


def _library_path(name: str) -> str:
    """The library of source ``name``, named by the hash of the source,
    every header in ``HEADERS`` and the flags."""
    h = hashlib.sha256()
    for path in (SOURCES[name], *HEADERS):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build() -> dict:
    """Compile every source in ``SOURCES`` whose library is not built
    yet for its current hash, one ``nvcc`` per source, all started
    together; returns {library name: path}. Raises with nvcc's output
    on failure."""
    global BUILD_LOG
    paths = {name: _library_path(name) for name in SOURCES}
    running = []
    for name, out in paths.items():
        if os.path.exists(out):
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, SOURCES[name]]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        running.append((name, cmd, proc, tmp))
    logs, failed = [], []
    for name, cmd, proc, tmp in running:
        out, _ = proc.communicate()
        logs.append(f"[{name}] {out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}")
        else:
            os.replace(tmp, paths[name])
    if running:
        BUILD_LOG = "\n".join(logs)
    if failed:
        raise KernelError("\n".join(failed) + "\n" + BUILD_LOG)
    return paths


def _bind(name: str, lib) -> None:
    """Set the argument and result types of library ``name``'s C
    functions, each prefixed with the library's name."""
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    args = {"ffd": LAUNCH_ARGS, "stream_bf": STREAM_LAUNCH_ARGS,
            "repair": REPAIR_LAUNCH_ARGS}[name]
    launch = getattr(lib, f"{name}_launch")
    launch.argtypes = [i32 if kind == "int" else ptr for _, kind in args]
    launch.restype = i32
    smem = getattr(lib, f"{name}_max_dynamic_smem")
    smem.argtypes = [i32]
    smem.restype = i32
    blocks = getattr(lib, f"{name}_blocks")
    blocks.argtypes = [i32] * {"ffd": 11, "stream_bf": 9, "repair": 9}[name]
    blocks.restype = i32
    error = getattr(lib, f"{name}_error_string")
    error.argtypes = [i32]
    error.restype = ctypes.c_char_p


def library(name: str = "ffd"):
    """The loaded kernel library ``name`` (every library is built at
    first use)."""
    if name not in _libs:
        for lib_name, path in build().items():
            if lib_name not in _libs:
                try:
                    lib = ctypes.CDLL(path)
                except OSError as err:
                    raise KernelError(f"cannot load {path}: {err}") from err
                _bind(lib_name, lib)
                _libs[lib_name] = lib
    return _libs[name]


def _dims(packed, stacked: bool = False):
    """(T, (C, K, S, R, W, A)): one problem (T = 1), or T problems of one
    shape stacked along a leading axis (``stacked``), with one tenant's
    dims."""
    if not stacked:
        return 1, shapes(packed)
    if packed.slot_req.dim() != 4:
        raise ValueError(
            f"a stacked pack has slot_req [T, C, K, R], not "
            f"{tuple(packed.slot_req.shape)}"
        )
    T, C, K, R = packed.slot_req.shape
    return T, (C, K, packed.spot_free.shape[1], R,
               packed.spot_taints.shape[2], packed.spot_aff.shape[2])


def _check(packed, stacked: bool = False) -> None:
    T, dims = _dims(packed, stacked)
    dev = packed.slot_req.device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be on a CUDA device, not {dev}")
    if T < 1:
        raise ValueError("a stacked launch needs at least one tenant")
    lead = (T,) if stacked else ()
    for name, dtype, shape_fn in _FIELDS:
        t = getattr(packed, name)
        want = lead + shape_fn(*dims)
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != want:
            raise ValueError(
                f"{name}: want {dtype} {want} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _smem_limit(name: str, device_index: int) -> int:
    """The dynamic shared memory a block of library ``name``'s kernels
    may take on the card (read once per device)."""
    limit = _SMEM_LIMIT.get((name, device_index))
    if limit is None:
        limit = getattr(library(name), f"{name}_max_dynamic_smem")(
            device_index
        )
        if limit < 0:
            raise KernelError("cannot read the card's shared-memory limit")
        _SMEM_LIMIT[(name, device_index)] = limit
    return limit


def _sm_count(device_index: int) -> int:
    count = _SM_COUNT.get(device_index)
    if count is None:
        count = torch.cuda.get_device_properties(
            device_index
        ).multi_processor_count
        _SM_COUNT[device_index] = count
    return count


def card_geometry(packed, best_fit: bool, *, spot_chunk: int | None = None,
                  layout=None, stacked: bool = False) -> FfdGeometry:
    """The geometry B1/B2 (B3 with ``spot_chunk``, B4 with its carry
    ``layout``, B1t/B2t on a ``stacked`` pack: one tenant's shapes) take
    for ``packed`` on its card."""
    _, (C, K, S, R, W, A) = _dims(packed, stacked)
    if spot_chunk is not None:
        S = min(S, spot_chunk)  # a block holds one chunk's statics
    index = _device_index(packed.slot_req.device)
    name = "ffd" if layout is None else "stream_bf"
    return launch_geometry(C, K, S, R, W, A, _smem_limit(name, index),
                           best_fit, n_sm=_sm_count(index), layout=layout)


def grid_blocks(packed, geometry: FfdGeometry, best_fit: bool,
                layout=None, *, stacked: bool = False) -> int:
    """Blocks of the persistent grid a launch in ``geometry`` takes on
    ``packed``'s card (``ffd_blocks``, or ``stream_bf_blocks`` for B4:
    CUDA's occupancy), for each tenant of a ``stacked`` pack."""
    T, (C, _, _, R, W, A) = _dims(packed, stacked)
    name = "ffd" if layout is None else "stream_bf"
    with torch.cuda.device(_device_index(packed.slot_req.device)):
        return _blocks(name, C, R, W, A, best_fit, geometry, T)


def _blocks(name: str, C: int, R: int, W: int, A: int, best_fit: bool,
            geometry: FfdGeometry, tenants: int = 1) -> int:
    """``grid_blocks`` on the current device (B5's, for ``name``
    "repair")."""
    lib = library(name)
    shape = (geometry.lanes_per_block, geometry.warps_per_lane,
             int(geometry.statics_in_smem), geometry.smem_bytes,
             int(not geometry.lanes_in_smem))
    if name == "ffd":
        blocks = lib.ffd_blocks(C, R, W, A, int(best_fit), *shape, tenants)
    else:
        blocks = getattr(lib, f"{name}_blocks")(C, R, W, A, *shape)
    if blocks < 0:
        _raise_on(lib, name, -blocks)
    return blocks


def _lane_workspace(name: str, C: int, R: int, W: int, A: int,
                    best_fit: bool, geometry: FfdGeometry, tenants: int,
                    dev) -> tuple:
    """(tensor or None, pointer, words) of the device-memory lane
    workspace a launch of library ``name`` in ``geometry`` takes on the
    current device: one lane slot for each lane of each block of each
    tenant's grid, none where the lanes sit in shared memory."""
    if geometry.lanes_in_smem:
        return None, 0, 0
    blocks = _blocks(name, C, R, W, A, best_fit, geometry, tenants)
    words = blocks * tenants * geometry.lanes_per_block * (
        geometry.lane_bytes // 4)
    if words >= 2**31:
        raise ValueError(f"a lane workspace of {words} words")
    ws = torch.empty((words,), dtype=torch.int32, device=dev)
    return ws, ws.data_ptr(), words


def _stream_codes(layout) -> tuple:
    try:
        return (
            USED_CODES[layout.used],
            COUNT_CODES[layout.count],
            AFF_CODES[layout.aff],
        )
    except KeyError as err:
        raise ValueError(f"kernel B4 has no plane of dtype {err}") from None


def _device_index(dev) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def _raise_on(lib, name: str, err: int) -> None:
    if err != 0:
        message = getattr(lib, f"{name}_error_string")(err).decode()
        raise KernelError(f"{name} kernel launch failed: {message}")


def _launch(name: str, packed, geometry: FfdGeometry, *,
            stacked: bool = False, **dims):
    """One launch of library ``name``'s kernel on ``packed`` (T problems
    of a ``stacked`` pack: B1t/B2t) in ``geometry`` with the further int
    arguments ``dims``: (feasible bool [C], chosen int32 [C, K]), with a
    leading [T] when stacked; ``packed`` checked by the caller."""
    lib = library(name)
    T, (C, K, S, R, W, A) = _dims(packed, stacked)
    lead = (T,) if stacked else ()
    dev = packed.slot_req.device
    index = _device_index(dev)
    feasible = torch.empty(lead + (C,), dtype=torch.bool, device=dev)
    chosen = torch.empty(lead + (C, K), dtype=torch.int32, device=dev)
    spec = LAUNCH_ARGS if name == "ffd" else STREAM_LAUNCH_ARGS
    with torch.cuda.device(index):
        _ws, ws_ptr, ws_words = _lane_workspace(
            name, C, R, W, A, dims.get("best_fit", 1), geometry, T, dev)
        args = {n: getattr(packed, n).data_ptr() for n, _, _ in _FIELDS}
        args.update(
            feasible=feasible.data_ptr(),
            chosen=chosen.data_ptr(),
            lane_ws=ws_ptr,
            lane_ws_words=ws_words,
            C=C, K=K, R=R, W=W, A=A, S=S,
            lanes_per_block=geometry.lanes_per_block,
            warps_per_lane=geometry.warps_per_lane,
            statics_in_smem=int(geometry.statics_in_smem),
            smem_bytes=geometry.smem_bytes,
            tenants=T,
            stream=torch.cuda.current_stream(index).cuda_stream,
            **dims,
        )
        err = getattr(lib, f"{name}_launch")(*(args[n] for n, _ in spec))
    _raise_on(lib, name, err)
    return feasible, chosen


def launch_raw(packed, best_fit: bool, geometry: FfdGeometry | None = None,
               spot_chunk: int | None = None):
    """One B1/B2 launch, or B3's over spot chunks of ``spot_chunk``
    spots, uncounted: (feasible bool [C], chosen int32 [C, K] with -1 for
    unplaced slots, NOT masked by lane feasibility; lanes with
    cand_valid=0 report feasible=0 and chosen=-1). Launches in
    ``geometry``, by default ``card_geometry``; the kernel allocates
    nothing."""
    _check(packed)
    S = packed.spot_free.shape[0]
    chunk = max(1, S) if spot_chunk is None else int(spot_chunk)
    if chunk < 1 or (best_fit and chunk < S):
        raise ValueError(f"spot chunk {chunk} for best_fit={best_fit}, S={S}")
    if geometry is None:
        geometry = card_geometry(packed, best_fit, spot_chunk=chunk)
    return _launch("ffd", packed, geometry, spot_chunk=chunk,
                   best_fit=int(best_fit))


def launch_stream_raw(packed, layout, geometry: FfdGeometry | None = None):
    """One B4 launch, uncounted: (feasible, chosen) as ``launch_raw``.
    Each lane's overlay holds its entries in ``layout``'s dtypes; the
    statics are staged in shared memory or read from device memory as
    ``geometry`` (by default ``card_geometry``) says; nothing is
    allocated beside the outputs."""
    _check(packed)
    codes = _stream_codes(layout)
    if geometry is None:
        geometry = card_geometry(packed, True, layout=layout)
    return _launch("stream_bf", packed, geometry, used_code=codes[0],
                   count_code=codes[1], aff_code=codes[2])


def plan_ffd_kernel(packed, best_fit: bool = False) -> SolveResult:
    """B1 (first-fit) or B2 (``best_fit``): the contract of
    ``solver/ffd.plan_ffd``. CPU tensors take the plain version."""
    if not packed.slot_req.is_cuda:
        return plan_ffd(packed, best_fit=best_fit)
    feasible, chosen = launch_raw(packed, best_fit)
    LAUNCHES["B2" if best_fit else "B1"] += 1
    assignment = torch.where(feasible[:, None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def launch_tenants_raw(stacked, best_fit: bool,
                       geometry: FfdGeometry | None = None):
    """One B1t/B2t launch over T stacked problems, uncounted: (feasible
    bool [T, C], chosen int32 [T, C, K]), each tenant's rows what
    ``launch_raw`` gives for it alone. Launches in ``geometry``, by
    default ``card_geometry`` on one tenant's shapes, on a grid of
    ``grid_blocks`` x T blocks."""
    _check(stacked, stacked=True)
    if geometry is None:
        geometry = card_geometry(stacked, best_fit, stacked=True)
    S = stacked.spot_free.shape[1]
    return _launch("ffd", stacked, geometry, stacked=True,
                   spot_chunk=max(1, S), best_fit=int(best_fit))


def plan_ffd_tenants_plain(stacked, best_fit: bool = False) -> SolveResult:
    """B1t's and B2t's plain version: ``solver/ffd.plan_ffd`` on each
    tenant of a stacked pack, stacked: feasible [T, C], assignment
    [T, C, K]."""
    T = stacked.slot_req.shape[0]
    if T < 1:
        raise ValueError("a stacked solve needs at least one tenant")
    results = [plan_ffd(tenant_slice(stacked, t), best_fit=best_fit)
               for t in range(T)]
    return SolveResult(
        feasible=torch.stack([r.feasible for r in results]),
        assignment=torch.stack([r.assignment for r in results]),
    )


def plan_ffd_tenants_kernel(stacked, best_fit: bool = False) -> SolveResult:
    """B1t (first-fit) or B2t (``best_fit``): B1/B2 over T stacked
    problems of one shape in one launch (the planner service's batch),
    the contract of ``plan_ffd`` per tenant: feasible [T, C], assignment
    [T, C, K]. CPU tensors take the plain version."""
    if not stacked.slot_req.is_cuda:
        return plan_ffd_tenants_plain(stacked, best_fit)
    feasible, chosen = launch_tenants_raw(stacked, best_fit)
    LAUNCHES["B2t" if best_fit else "B1t"] += 1
    assignment = torch.where(feasible[..., None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def plan_ffd_chunked_plain(packed, spot_chunk: int) -> SolveResult:
    """B3's plain version: first-fit over ordered spot chunks of
    ``spot_chunk`` spots, each a ``solver/ffd.ffd_raw`` pass over the
    pods still unplaced."""
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
        _, chosen_b = ffd_raw(sub, False)
        placed_b = chosen_b >= 0
        chosen_total = torch.where(placed_b, chosen_b + off, chosen_total)
        remaining = remaining & ~placed_b
    # a lane is feasible iff nothing valid remains unplaced
    feasible = packed.cand_valid & ~remaining.any(dim=1)
    assignment = torch.where(feasible[:, None], chosen_total, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def plan_ffd_chunked(packed, spot_chunk: int) -> SolveResult:
    """B3: first-fit over spot chunks of ``spot_chunk`` spots, one launch
    whose blocks walk the chunks in order. CPU tensors take the plain
    version."""
    if not packed.slot_req.is_cuda:
        return plan_ffd_chunked_plain(packed, spot_chunk)
    feasible, chosen = launch_raw(packed, False, spot_chunk=spot_chunk)
    LAUNCHES["B3"] += 1
    assignment = torch.where(feasible[:, None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def greedy_solver():
    """The union's greedy pass, ``solve(packed, best_fit=False)``: B1 for
    first-fit, B2 for best-fit."""

    def solve(packed, best_fit: bool = False) -> SolveResult:
        return plan_ffd_kernel(packed, best_fit=best_fit)

    return solve


def plan_stream_ff_kernel(
    packed, *, carry_chunks: int = 2, layout=NARROW_LAYOUT
) -> SolveResult:
    """The carry-streamed union's first-fit (the contract of
    ``solver/ffd.plan_ffd_streamed``): B1 for one chunk, one B3 launch
    over spot chunks of ceil(S / ``carry_chunks``) spots for more. The
    kernels hold their overlay entries wide, so ``layout`` sizes only the
    plain version, which CPU tensors take."""
    if not packed.slot_req.is_cuda:
        return plan_ffd_streamed(
            packed, carry_chunks=carry_chunks, layout=layout
        )
    if carry_chunks <= 1:
        return plan_ffd_kernel(packed)
    S = packed.spot_free.shape[0]
    return plan_ffd_chunked(packed, max(1, -(-S // carry_chunks)))


def plan_stream_bf_kernel(
    packed, *, carry_chunks: int = 2, layout=NARROW_LAYOUT
) -> SolveResult:
    """B4: the fused best-fit stream solve over the narrow delta carry
    ``layout`` (the contract of ``plan_ffd_streamed(best_fit=True)``
    and of the JAX package's ``plan_stream_bf_pallas``). Each lane's
    overlay holds the carry of the spots it touched, in shared memory
    even where the statics pass it (in the lane workspace past one
    lane's shared memory). ``carry_chunks`` does not change the result: the chunked election
    is the global one; it sizes only the plain version, which CPU
    tensors take."""
    if not packed.slot_req.is_cuda:
        return plan_ffd_streamed(
            packed, carry_chunks=carry_chunks, layout=layout, best_fit=True
        )
    feasible, chosen = launch_stream_raw(packed, layout)
    LAUNCHES["B4"] += 1
    assignment = torch.where(feasible[:, None], chosen, -1)
    return SolveResult(feasible=feasible, assignment=assignment)


def card_repair_geometry(packed, rounds: int) -> FfdGeometry:
    """The geometry B5 takes for ``packed`` and ``rounds`` on its card."""
    C, K, S, R, W, A = shapes(packed)
    index = _device_index(packed.slot_req.device)
    return repair_geometry(C, K, S, R, W, A, rounds,
                           _smem_limit("repair", index),
                           n_sm=_sm_count(index))


def launch_repair_raw(packed, unproven, rounds: int, chain: bool = True,
                      geometry: FfdGeometry | None = None) -> torch.Tensor:
    """One B5 launch, uncounted: int32 [C, K], the repaired (not yet
    validated) assignment of each lane ``unproven`` (bool [C]) marks,
    -1 rows elsewhere. Launches in ``geometry``, by default
    ``card_repair_geometry``; the kernel allocates nothing (the wrapper
    allocates the lane workspace, where the geometry takes one)."""
    _check(packed)
    C, K, S, R, W, A = shapes(packed)
    dev = packed.slot_req.device
    if (unproven.device != dev or unproven.dtype != torch.bool
            or tuple(unproven.shape) != (C,) or not unproven.is_contiguous()):
        raise ValueError(
            f"unproven: want contiguous torch.bool ({C},) on {dev}, got "
            f"{unproven.dtype} {tuple(unproven.shape)} on {unproven.device}"
        )
    if rounds < 0 or K < 1 or S < 1:
        raise ValueError(f"B5 takes rounds >= 0, K >= 1, S >= 1, not "
                         f"{rounds}, {K}, {S}")
    if geometry is None:
        geometry = card_repair_geometry(packed, rounds)
    lib = library("repair")
    index = _device_index(dev)
    assign = torch.empty((C, K), dtype=torch.int32, device=dev)
    with torch.cuda.device(index):
        _ws, ws_ptr, ws_words = _lane_workspace(
            "repair", C, R, W, A, True, geometry, 1, dev)
        args = {n: getattr(packed, n).data_ptr() for n, _, _ in _FIELDS}
        args.update(
            unproven=unproven.data_ptr(),
            assign=assign.data_ptr(),
            lane_ws=ws_ptr,
            lane_ws_words=ws_words,
            C=C, K=K, R=R, W=W, A=A, S=S,
            rounds=int(rounds), chain=int(bool(chain)),
            lanes_per_block=geometry.lanes_per_block,
            warps_per_lane=geometry.warps_per_lane,
            statics_in_smem=int(geometry.statics_in_smem),
            smem_bytes=geometry.smem_bytes,
            stream=torch.cuda.current_stream(index).cuda_stream,
        )
        err = lib.repair_launch(*(args[n] for n, _ in REPAIR_LAUNCH_ARGS))
    _raise_on(lib, "repair", err)
    return assign


def plan_repair_plain(packed, unproven, rounds: int,
                      chain: bool = True) -> torch.Tensor:
    """B5's plain version, the tests' reference for ``launch_repair_raw``:
    ``solver/repair.repair_from`` after the partial pass (best-fit's
    greedy pass) on every lane, -1 rows where ``unproven`` is False."""
    assign = repair_from(packed, greedy_pass(packed, True), rounds, chain)
    return torch.where(unproven[:, None], assign, -1).to(torch.int32)


def plan_repair_kernel(packed, unproven, rounds: int,
                       chain: bool = True) -> SolveResult:
    """The union's unchunked repair: on a CUDA pack, B5 over the lanes
    ``unproven`` marks, one launch, then the plain from-scratch
    validation (``solver/repair.validated``); the rows of every other
    lane report infeasible, which the union never reads (it keeps
    greedy's answer there). CPU tensors take the plain
    ``solver/repair.plan_repair``."""
    if not packed.slot_req.is_cuda:
        return plan_repair(packed, rounds=rounds, chain=chain)
    with tracing.span("repair.kernel"):
        assign = launch_repair_raw(packed, unproven, rounds, chain)
        LAUNCHES["B5"] += 1
    with tracing.span("repair.validate"):
        return validated(packed, assign)
