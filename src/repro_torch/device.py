"""Where the port runs: the one rule every entry point applies.

``device=None`` means the card (``"cuda"``).  Without CUDA that is a typed
``DeviceInitError``: nothing carries on on the CPU unless the caller asked
for it with ``device="cpu"`` (as the tests do).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.errors import DeviceInitError


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


__all__ = ["resolve_device"]
