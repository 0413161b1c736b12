"""The wide delta-carry layout of the greedy and repair passes.

The mutable per-(lane, spot) state is held as DELTAS against the static
spot rows: capacity consumed (``used``), placements added (``count``)
and the affinity bits placed pods contributed (``aff``). One widen site
(``solver/ffd._widen``) rebuilds the absolute values for every read.

Only the wide layout is ported here; its dtypes are exact for every
pack (integral f32 below 2**24). The affinity plane is int32 bits, the
port's word convention (``models/tensors``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CarryLayout(NamedTuple):
    """Dtypes of the three mutable carry planes (delta form)."""

    used: torch.dtype = torch.float32
    count: torch.dtype = torch.int32
    aff: torch.dtype = torch.int32


WIDE_LAYOUT = CarryLayout()
