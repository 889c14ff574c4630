"""Where the port runs: on the card, unless the caller names another device."""

from __future__ import annotations

import os

import torch

DEFAULT_DEVICE = "cuda"


def resolve_device(device=DEFAULT_DEVICE) -> torch.device:
    """``torch.device(device)``. A CUDA device initialises CUDA first, so that
    on a machine without a card the call raises torch.cuda's own error rather
    than running anywhere else.

    Under ``torch.distributed.run`` (``LOCAL_RANK`` set), a CUDA device
    without an index means this rank's card, ``cuda:LOCAL_RANK``, which
    becomes the current device before anything launches. A device with an
    index is taken as given: ranks that all name ``cuda:0`` share one card."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.init()
        if device.index is None and "LOCAL_RANK" in os.environ:
            device = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            torch.cuda.set_device(device)
    return device
