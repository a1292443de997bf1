"""Device meshes for the sharded PIR path (twin of ``repro/launch/mesh.py``).

The JAX package shards with ``shard_map`` over a ``jax.sharding.Mesh``:
one Python program drives every device.  The port keeps that single
controller: a `DeviceMesh` is the ordered tuple of the shards' devices
(shard s on ``devices[s]``, rows sharded over one ``chunks`` axis), and the
sharded entry points (`distributed.collectives`) launch each shard's kernel
on its own device from this one process.  No ``torch.distributed`` process
group is involved, so several shards may share one card (four shards on
``cuda:0`` show placement and equality, not scaling), and the tests place
shards on ``["cpu"] * S``.

Functions, not module-level constants: importing this module touches no
device.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class DeviceMesh:
    """The row shards' devices, in shard order."""
    devices: tuple[torch.device, ...]

    @property
    def home(self) -> torch.device:
        """The controller's device: replicated operands start here and
        gathered results (answers, the client's hint) end here."""
        return self.devices[0]

    def __str__(self) -> str:
        shards = ", ".join(f"{i}:{d}" for i, d in enumerate(self.devices))
        shared = len(set(self.devices)) < len(self.devices)
        return (f"DeviceMesh({len(self.devices)} shards; shard:device "
                f"{shards}" + ("; shards share a device" if shared else "")
                + ")")


def make_local_mesh(shards: int, devices=None) -> DeviceMesh:
    """A mesh of ``shards`` row shards over the visible cards: shard s on
    card ``s mod torch.cuda.device_count()``.  ``devices`` (one entry per
    shard, e.g. ``["cpu"] * shards``) places them explicitly; without it
    and without a card this raises."""
    if shards < 1:
        raise ValueError(f"shards must be >= 1, got {shards}")
    if devices is not None:
        if len(devices) != shards:
            raise ValueError(f"{len(devices)} devices for {shards} shards")
        return DeviceMesh(tuple(torch.device(d) for d in devices))
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for the mesh: pass devices= "
                           "(e.g. ['cpu'] * shards) to shard on the CPU")
    cards = torch.cuda.device_count()
    return DeviceMesh(tuple(torch.device("cuda", s % cards)
                            for s in range(shards)))
