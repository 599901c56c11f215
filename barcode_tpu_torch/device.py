"""Device resolution for the port's entry points.

Entry points run on the card unless the caller asks for the CPU: there is
no silent fallback, so a run that was meant for the GPU never quietly
measures the host instead.
"""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device for `device` (default "cuda"); raises if CUDA is asked
    for and no card is present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the host")
    return dev
