"""The device an entry point of the port runs on.

The port runs on the card unless the caller asks for the CPU: every entry
point defaults to `"cuda"`, and a CUDA device that is not there is an error,
never a quiet move to the CPU.
"""
from __future__ import annotations

import torch


def resolve(device, arg: str = "device=") -> torch.device:
    """`device` as a torch.device; raises when it names a CUDA device and there
    is none, or a device type the port does not run on. `arg` is how the
    caller's own argument is spelled in the message."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{arg}{device}: no CUDA device here (pass {arg}cpu to run on the CPU)"
        )
    if dev.type not in ("cpu", "cuda"):
        raise RuntimeError(f"{arg}{device}: the port runs on 'cpu' or 'cuda'")
    return dev


def name(device: torch.device) -> str:
    """The card's name for a CUDA device, "cpu" for the CPU (reports name
    the device every result ran on)."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
