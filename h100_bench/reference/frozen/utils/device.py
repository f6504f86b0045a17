"""Where the port's entry points run: on the card unless asked for the CPU."""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a torch.device; a CUDA device that is not there raises
    at once (nothing carries on on the CPU unasked)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested and no CUDA device is available; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev
