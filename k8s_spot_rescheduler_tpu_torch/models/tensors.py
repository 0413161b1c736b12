"""The static-shape planning problem, as numpy on the host and as torch
tensors on the device.

``PackedCluster`` copies the 11-field contract of the JAX package's
``models/tensors.PackedCluster``: C candidate lanes, K pod slots, S spot
nodes, R resources, W taint words, A affinity words.

- host form (numpy, what a pack produces): ``slot_req`` f32 [C, K, R],
  ``slot_valid`` bool [C, K], ``slot_tol`` u32 [C, K, W], ``slot_aff``
  u32 [C, K, A], ``cand_valid`` bool [C], ``spot_free`` f32 [S, R],
  ``spot_count`` i32 [S], ``spot_max_pods`` i32 [S], ``spot_taints`` u32
  [S, W], ``spot_ok`` bool [S], ``spot_aff`` u32 [S, A];
- device form (torch): the same shapes, with the three kinds of uint32
  words held as **int32 bit patterns** (``.view(np.int32)``). Torch's
  uint32 has no ``~`` and no ``amax`` on the CPU; ``&``, ``|``, ``~``
  and ``== 0`` on the int32 view give the same bits.

``to_device`` and ``to_numpy`` carry a pack across without losing a bit;
``save_npz`` and ``load_npz`` freeze one to disk.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device


class PackedCluster(NamedTuple):
    """The problem tensors (numpy on the host, torch on the device)."""

    # candidate pod slots
    slot_req: object  # f32 [C, K, R]
    slot_valid: object  # bool [C, K]
    slot_tol: object  # u32 (host) / i32 bits (device) [C, K, W]
    slot_aff: object  # u32 (host) / i32 bits (device) [C, K, A]
    cand_valid: object  # bool [C]
    # spot pool
    spot_free: object  # f32 [S, R]
    spot_count: object  # i32 [S]
    spot_max_pods: object  # i32 [S]
    spot_taints: object  # u32 (host) / i32 bits (device) [S, W]
    spot_ok: object  # bool [S]
    spot_aff: object  # u32 (host) / i32 bits (device) [S, A]


# host dtype of every field; the WORD_FIELDS travel as int32 bits
HOST_DTYPES = {
    "slot_req": np.float32,
    "slot_valid": np.bool_,
    "slot_tol": np.uint32,
    "slot_aff": np.uint32,
    "cand_valid": np.bool_,
    "spot_free": np.float32,
    "spot_count": np.int32,
    "spot_max_pods": np.int32,
    "spot_taints": np.uint32,
    "spot_ok": np.bool_,
    "spot_aff": np.uint32,
}
WORD_FIELDS = ("slot_tol", "slot_aff", "spot_taints", "spot_aff")


def host_array(name: str, arr) -> np.ndarray:
    """``arr`` as the contiguous device-ready numpy array of field
    ``name``: the host dtype, with words reinterpreted as int32 bits."""
    out = np.ascontiguousarray(np.asarray(arr, HOST_DTYPES[name]))
    if name in WORD_FIELDS:
        out = out.view(np.int32)
    return out


def to_device(packed, device=None) -> PackedCluster:
    """A host PackedCluster (numpy) as torch tensors on ``device``
    (default ``cuda``; a CUDA request without a card raises). Always a
    copy: on the CPU too, the tensors never alias the numpy arrays, so
    writing into them in place leaves the host pack as it was."""
    dev = resolve_device(device)
    return PackedCluster(
        *(
            torch.from_numpy(host_array(f, getattr(packed, f))).to(
                dev, copy=True
            )
            for f in PackedCluster._fields
        )
    )


def to_numpy(packed) -> PackedCluster:
    """A device PackedCluster back in host form (uint32 words)."""
    out = []
    for f in PackedCluster._fields:
        arr = getattr(packed, f).detach().cpu().numpy()
        if f in WORD_FIELDS:
            arr = arr.view(np.uint32)
        out.append(arr)
    return PackedCluster(*out)


def save_npz(path: str, packed, **extra) -> None:
    """Write a host PackedCluster (and ``extra`` arrays) compressed."""
    np.savez_compressed(
        path,
        **{f: np.asarray(getattr(packed, f)) for f in PackedCluster._fields},
        **extra,
    )


def load_npz(path: str):
    """(host PackedCluster, dict of the other arrays in the file)."""
    with np.load(path) as z:
        packed = PackedCluster(
            *(
                np.asarray(z[f], HOST_DTYPES[f])
                for f in PackedCluster._fields
            )
        )
        extra = {k: z[k] for k in z.files if k not in PackedCluster._fields}
    return packed, extra


def shapes(packed):
    """(C, K, S, R, W, A) of a PackedCluster in either form."""
    C, K, R = packed.slot_req.shape
    S = packed.spot_free.shape[0]
    return C, K, S, R, packed.spot_taints.shape[1], packed.spot_aff.shape[1]
