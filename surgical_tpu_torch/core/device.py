"""Where the port runs: on the card, unless the caller names another device."""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``. A CUDA device initialises CUDA first, so that
    on a machine without a card the call raises torch.cuda's own error rather
    than running anywhere else."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
    return device
