"""A mesh of shard slots.

The port of the JAX package's `parallel/mesh.py`. There a mesh is a grid
of devices and `shard_map` runs one program per device. Here one Python
process drives every slot (`parallel/shuffle.py` `run_sharded`): a slot
is a row shard with the `torch.device` it computes on, and several slots
may share one device. On a machine with one card, `make_mesh(4)` gives
four slots on that card, which run one after another and exchange rows
by device copies; with several cards each slot may have its own, and an
exchanged block is one peer copy.

A 1-D mesh has the axis "shards"; a 2-D mesh "hosts" x "chips", whose
exchanges route in two stages (chips first, then hosts between slots of
one chip index). Slot order is row-major: slot h * C + c.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch

__all__ = ["AXIS", "HOST_AXIS", "CHIP_AXIS", "Mesh", "make_mesh",
           "make_mesh2", "total_shards", "is_mesh_2d", "indexed_device"]

AXIS = "shards"
HOST_AXIS = "hosts"
CHIP_AXIS = "chips"


class Mesh:
    """Slots on devices: `devices` lists each slot's device in slot
    order, `shape` maps each axis name to its size."""

    __slots__ = ("devices", "shape", "axis_names")

    def __init__(self, devices: Sequence[torch.device],
                 shape: Dict[str, int]):
        n = 1
        for v in shape.values():
            n *= v
        if n != len(devices) or n < 1:
            raise ValueError(f"mesh shape {shape} does not hold "
                             f"{len(devices)} slots")
        self.devices: List[torch.device] = [indexed_device(d)
                                            for d in devices]
        self.shape = dict(shape)
        self.axis_names = tuple(shape)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        """Slot 0's device: where a sharded table lives whole, and where
        a step's per-slot outputs are put back together."""
        return self.devices[0]

    def __repr__(self) -> str:
        shape = " x ".join(f"{k}={v}" for k, v in self.shape.items())
        return f"Mesh({shape}; {[str(d) for d in self.devices]})"


def indexed_device(d) -> torch.device:
    """A device with its index ("cuda" -> "cuda:<current>"), so that it
    compares equal to a tensor's device."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def _slot_devices(n: Optional[int], devices, device) -> List[torch.device]:
    """Each slot's device: `devices` as given (the first n); n slots on
    `device`; or, by default, slot s on card s % cards (n = the number of
    cards when not given). The default needs a card."""
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        return devices[:n] if n is not None else devices
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available")
        return [dev] * (n if n is not None else 1)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: the default mesh puts one slot on each CUDA card, "
            "and CUDA is not available; pass device='cpu' (with a slot "
            "count) to shard on the CPU")
    cards = torch.cuda.device_count()
    n = cards if n is None else n
    return [torch.device("cuda", s % cards) for s in range(n)]


def make_mesh(n: Optional[int] = None, devices=None, device=None) -> Mesh:
    """A 1-D mesh of n slots (see `_slot_devices` for their devices)."""
    devs = _slot_devices(n, devices, device)
    return Mesh(devs, {AXIS: len(devs)})


def make_mesh2(n_hosts: int, chips_per_host: int, devices=None,
               device=None) -> Mesh:
    """A 2-D (hosts x chips) mesh of n_hosts * chips_per_host slots,
    row-major: slot h * chips_per_host + c."""
    devs = _slot_devices(n_hosts * chips_per_host, devices, device)
    return Mesh(devs, {HOST_AXIS: n_hosts, CHIP_AXIS: chips_per_host})


def is_mesh_2d(mesh: Mesh) -> bool:
    return HOST_AXIS in mesh.shape and CHIP_AXIS in mesh.shape


def total_shards(mesh: Mesh) -> int:
    return mesh.size
