"""Carry layouts: the per-(lane, spot) delta state, sized from exact
host-side bounds.

The mutable per-(lane, spot) state of the greedy and repair passes is
held as DELTAS against the static spot rows: capacity consumed
(``used``), placements added (``count``) and the affinity bits placed
pods contributed (``aff``). One widen site (``solver/ffd._widen``)
rebuilds the absolute values for every read, so the statics are never
copied per lane and each delta starts at zero.

The deltas are bounded by what one lane can do to one node, and
``carry_layout`` derives the narrowest dtypes those bounds provably fit
(a copy of the JAX package's ``solver/carry``; the guard is exact, so a
narrow layout never changes a placement):

- ``used[c, r, s]`` is the sum of the requests of lane c's pods on s,
  at most the lane's total valid request per resource;
- ``count[c, s]`` is at most K;
- ``aff[c, a, s]`` is an OR of ``slot_aff`` words, inside the OR of
  every slot's words.

A layout names its dtypes as strings (``"int16"``, ...), as the JAX
package's does, so the two compare field for field. ``torch_dtype`` is
the one place a name becomes a torch dtype for the plain versions:
torch's CPU build has no add or ``index_put`` for uint16 and no ``~``
for uint32, so a uint16 plane is held widened to int32 (its values fit)
and a uint32 word plane as int32 bits (the port's word convention,
``models/tensors``). Kernel B4 holds every plane in its own dtype.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class CarryLayout(NamedTuple):
    """Dtype names of the three delta planes. The default is the WIDE
    layout, exact for every pack (integral f32 below 2**24)."""

    used: str = "float32"
    count: str = "int32"
    aff: str = "uint32"


WIDE_LAYOUT = CarryLayout()
NARROW_LAYOUT = CarryLayout(used="int16", count="int8", aff="uint16")

_TORCH_DTYPES = {
    "int8": torch.int8,
    "uint8": torch.uint8,
    "int16": torch.int16,
    "uint16": torch.int32,  # widened: no uint16 add on torch's CPU build
    "int32": torch.int32,
    "uint32": torch.int32,  # int32 bits: the port's word convention
    "float32": torch.float32,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype the plain versions hold a plane named ``name`` in."""
    return _TORCH_DTYPES[name]


def _host(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def carry_layout(packed) -> CarryLayout:
    """The narrowest layout ``packed``'s exact bounds fit. ``packed`` is
    a host pack (numpy, uint32 words) or the port's tensors (int32 word
    bits): the affinity words are read as uint32 either way, so a word
    with bit 31 set widens to uint32 instead of reading negative."""
    req = _host(packed.slot_req)
    valid = _host(packed.slot_valid)
    consumed_max = 0.0
    if req.size:
        consumed_max = float(
            (req * valid[:, :, None].astype(req.dtype)).sum(axis=1).max()
        )
    if consumed_max <= np.iinfo(np.int16).max:
        used = "int16"
    elif consumed_max <= np.iinfo(np.uint16).max:
        # consumed is invariantly >= 0, so the unsigned range is safe
        used = "uint16"
    else:
        used = "float32"  # exact up to 2**24, the pack contract
    K = req.shape[1] if req.ndim == 3 else 0
    count = "int8" if K <= np.iinfo(np.int8).max else "int16"
    slot_aff = _host(packed.slot_aff)
    if slot_aff.dtype == np.int32:
        slot_aff = slot_aff.view(np.uint32)
    aff_bits = (
        int(np.bitwise_or.reduce(slot_aff, axis=None)) if slot_aff.size else 0
    )
    if aff_bits <= 0xFF:
        aff = "uint8"
    elif aff_bits <= 0xFFFF:
        aff = "uint16"
    else:
        aff = "uint32"
    return CarryLayout(used=used, count=count, aff=aff)


def plane_bytes(layout: CarryLayout, R: int, A: int) -> int:
    """Carry bytes per (lane, spot) under ``layout``: R used planes, one
    count plane and A affinity planes (the wide layout: 4*(R + A + 1))."""
    return (
        R * np.dtype(layout.used).itemsize
        + np.dtype(layout.count).itemsize
        + A * np.dtype(layout.aff).itemsize
    )


def is_narrow(layout: CarryLayout) -> bool:
    """True when any carry plane is narrower than the wide layout."""
    return layout != WIDE_LAYOUT
