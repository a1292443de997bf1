"""Device resolution and the u32-in-int32 storage convention.

torch has almost no ``uint32`` arithmetic (add, shifts, ``%`` and matmul all
raise "not implemented for 'UInt32'"), so the port stores every u32 value as
the ``torch.int32`` tensor with the same bit pattern.  Elementwise modular
arithmetic widens to int64 (`as_i64`, values in [0, 2^32)), masks with
``& MASK`` and narrows back with `wrap_i32`.  Nothing relies on int32
wraparound, arithmetic ``>>`` or ``%`` of negative values.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch

MASK = 0xFFFFFFFF


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless told otherwise.

    Raises when a CUDA device is asked for (explicitly or by default) and
    none is present -- the port never drops quietly to the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run on the CPU")
    return dev


def on_device(device: torch.device):
    """Context making ``device`` the current CUDA device (nothing on the
    CPU): the port's kernels launch on the current device's stream, so a
    shard on another card must be launched from inside it."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """``a`` as a tensor on ``device``, queued without waiting on the stream
    (a pinned, non-blocking copy on the card; on the CPU the tensor shares
    memory with ``a``).  A blocking copy would wait for every product
    already queued on the stream."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:      # e.g. a view of a JAX array
        a = a.copy()
    t = torch.from_numpy(a)
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


def to_host_async(t: torch.Tensor) -> torch.Tensor:
    """A host copy of ``t`` queued on the current stream (pinned, no wait):
    read it only once the stream has passed this point.  On the CPU, ``t``
    itself."""
    if not t.is_cuda:
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def as_i64(x: torch.Tensor) -> torch.Tensor:
    """u32 values held as int32 bits (or u8) → int64 in [0, 2^32)."""
    if x.dtype == torch.uint8:
        return x.to(torch.int64)
    if x.dtype != torch.int32:
        raise TypeError(f"expected int32-held u32 or uint8, got {x.dtype}")
    return x.to(torch.int64) & MASK


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 → the int32 tensor holding ``x mod 2^32`` as its bit pattern."""
    x = x & MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def u32_to_torch(a: np.ndarray, device) -> torch.Tensor:
    """numpy uint32 → int32-held tensor on ``device`` (bits unchanged)."""
    a = np.ascontiguousarray(a, dtype=np.uint32)
    if not a.flags.writeable:      # e.g. a view of a JAX array
        a = a.copy()
    return torch.from_numpy(a.view(np.int32)).to(device)


def u32_to_numpy(t: torch.Tensor) -> np.ndarray:
    """int32-held tensor → numpy uint32 (bits unchanged)."""
    if t.dtype != torch.int32:
        raise TypeError(f"expected int32-held u32, got {t.dtype}")
    return t.detach().cpu().numpy().view(np.uint32)
