"""Where the port runs: the one rule every entry point applies, and how
many devices of a kind there are to replicate a program over.

``device=None`` means the card (``"cuda"``).  Without CUDA that is a typed
``DeviceInitError``: nothing carries on on the CPU unless the caller asked
for it with ``device="cpu"`` (as the tests do).

Replicas are counted per device kind, as the reference counts
``jax.devices()``: on CUDA every visible card, on the CPU the host
replicas set by ``force_host_devices(n)`` (1 unless set) — the port's
counterpart of the reference's
``--xla_force_host_platform_device_count``.  Host replicas share the
host; they run one after another.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.errors import DeviceInitError

# host replicas the CPU offers (force_host_devices)
_host_devices = 1


def resolve_device(device: Optional[Union[str, torch.device]]) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceInitError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch path on the host")
    if dev.type not in ("cuda", "cpu"):
        raise DeviceInitError(f"unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def force_host_devices(n: int) -> None:
    """Offer ``n`` host replicas on the CPU (the default is 1).  Takes
    effect at once, for every engine built after the call."""
    global _host_devices
    n = int(n)
    if n < 1:
        raise ValueError(f"need at least one host device, got {n}")
    _host_devices = n


def device_count(device: torch.device) -> int:
    """Devices of ``device``'s kind a program can be replicated over."""
    if device.type == "cuda":
        return torch.cuda.device_count()
    return _host_devices


__all__ = ["device_count", "force_host_devices", "resolve_device"]
