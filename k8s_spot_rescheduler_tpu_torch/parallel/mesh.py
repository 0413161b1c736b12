"""Device meshes: the port of the JAX package's ``parallel/mesh.py``.

The solver's two parallel axes map onto a 2-D grid of devices:

- ``"cand"``: candidate on-demand nodes (pure data parallelism: the
  fork-per-candidate lanes never communicate);
- ``"spot"``: the spot pool (the first-fit probe needs the globally
  first fitting spot each step, elected across the spot shards).

The JAX mesh is single-controller: one process lays ``jax.devices()``
out as ``(cand, spot)`` or ``(tenant,)`` and ``shard_map`` runs a block
program on each. The port keeps that shape: one process holding a
``DeviceMesh``, a numpy object array of ``torch.device`` with axis
names, and no ``torch.distributed``. Each block's tensors live on its
device and its kernels launch there; CUDA launches are asynchronous,
so blocks on distinct cards overlap. A mesh may name one device more
than once (``[cuda:0] * 4``, or ``[cpu] * 4`` in the tests): every block
then runs its kernels, one after the other, on that device, with the
same results bit for bit.

Where the JAX package calls ``jax.devices()``, the port takes the
device list from its caller; ``default_devices`` gives every visible
card for a CUDA device and ``[cpu]`` otherwise.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from k8s_spot_rescheduler_tpu_torch.device import resolve_device
from k8s_spot_rescheduler_tpu_torch.models.tensors import (
    PackedCluster,
    host_array,
)

CAND_AXIS = "cand"
SPOT_AXIS = "spot"
TENANT_AXIS = "tenant"


class DeviceMesh:
    """A grid of devices with named axes (``jax.sharding.Mesh``'s
    counterpart): ``devices`` is a numpy object array of
    ``torch.device``, one axis per name; ``shape`` maps each axis name
    to its size."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str]):
        if devices.ndim != len(axis_names):
            raise ValueError(
                f"{devices.ndim}-D devices for axes {tuple(axis_names)}"
            )
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def lead(self) -> torch.device:
        """The mesh's first device: where cross-shard elections and the
        gathered results land."""
        return self.devices.flat[0]


def default_devices(device=None) -> list:
    """Every visible card when ``device`` (resolved: None means cuda,
    which raises without a card) is a CUDA device, else ``[cpu]``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def _grid(devices, shape: Tuple[int, ...]) -> np.ndarray:
    flat = np.empty(len(devices), dtype=object)
    flat[:] = [torch.device(d) for d in devices]
    return flat.reshape(shape)


def _devices(devices) -> list:
    return list(devices) if devices is not None else default_devices()


def pick_mesh_shape(n_devices: int) -> Tuple[int, int]:
    """(cand, spot) mesh shape for n devices: the cand axis (no
    collectives) takes the larger factor, the spot axis (one election a
    step) stays small, as in the JAX package."""
    spot = 1
    for s in (2,):
        if n_devices % s == 0 and n_devices > s:
            spot = s
    return n_devices // spot, spot


def make_cand_mesh(devices=None) -> DeviceMesh:
    """A 1-D mesh over the candidate axis only: every device holds a
    block of candidate lanes with the whole spot axis replicated
    (``parallel/sharded_ffd.plan_union_cand_sharded``)."""
    devices = _devices(devices)
    return DeviceMesh(_grid(devices, (len(devices),)), (CAND_AXIS,))


def make_tenant_mesh(devices=None) -> DeviceMesh:
    """A 1-D mesh over the tenant axis: every device holds a block of
    whole tenant problems (``parallel/tenant_batch``)."""
    devices = _devices(devices)
    return DeviceMesh(_grid(devices, (len(devices),)), (TENANT_AXIS,))


def make_mesh(shape: Tuple[int, int] | None = None,
              devices=None) -> DeviceMesh:
    """The 2-D (cand, spot) mesh of ``shape`` (``pick_mesh_shape`` of the
    device count when None) over the first cand x spot devices."""
    devices = _devices(devices)
    if shape is None:
        shape = pick_mesh_shape(len(devices))
    n = shape[0] * shape[1]
    if n > len(devices):
        raise ValueError(
            f"mesh shape {shape} needs {n} devices, have {len(devices)}"
        )
    return DeviceMesh(_grid(devices[:n], tuple(shape)), (CAND_AXIS, SPOT_AXIS))


_LANE_FIELDS = ("slot_req", "slot_valid", "slot_tol", "slot_aff",
                "cand_valid")


def place(packed, device, *, lanes: slice = slice(None),
          spots: slice = slice(None), tenants: slice | None = None):
    """One block of a PackedCluster (numpy, host words as uint32, or
    torch) as torch tensors on ``device``: the candidate fields cut to
    ``lanes``, the spot fields to ``spots``, every field first to
    ``tenants`` on a stacked pack. Sliced before it moves, so only the
    block crosses to the device."""
    out = []
    for f in PackedCluster._fields:
        arr = getattr(packed, f)
        if tenants is not None:
            arr = arr[tenants]
        cut = lanes if f in _LANE_FIELDS else spots
        arr = arr[(slice(None),) * (tenants is not None) + (cut,)]
        if not isinstance(arr, torch.Tensor):
            arr = torch.from_numpy(host_array(f, arr))
        out.append(arr.to(device))
    return PackedCluster(*out)
